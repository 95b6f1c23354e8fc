"""The port's e4e inverter against the JAX package's, on the CPU.

The same numpy weights (drawn by the port's seeded initialisers) and the
same numpy inputs go through both packages:

* the three encoders at progressive stages 0, 3, 7 and 18, and their
  primitives: rtol 1e-5, atol 1e-5·max|ref| (the body and heads are the
  tiny `TINY_E4E_LAYOUT` body; fp32 summation order differs);
* pSp encode / decode / latent_mask mixing at stylegan_size 32: 1e-4, the
  generator's tolerance;
* checkpoint export: identical keys and bit-equal tensors; import of a
  JAX-written file: bit-equal params, synthesis within 1e-4;
* infer_e4e against JAX's CLI on a full IR-SE-50 checkpoint (a checkpoint
  always holds the full body) at batch 2: projected_w.npz within rtol 1e-4,
  atol 1e-4·max|ref|, the saved reconstructions within ±1 per uint8; the
  same with --align (FFHQ alignment of 128² photos from seeded landmark
  weights): codes within rtol 1e-2, atol 2e-3·max|ref| (the landmarks'
  fp32 noise moves the alignment quad, and the aligned photos differ by
  ±1 per uint8 here and there);
* SeFa's boundaries and GANSpace / InterFaceGAN edits.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.cli import infer_e4e as jax_infer_e4e
from stylemc_tpu.io import export as jexport
from stylemc_tpu.io import rosinality as jros
from stylemc_tpu.models.e4e import editings as jedit
from stylemc_tpu.models.e4e import encoders as jenc
from stylemc_tpu.models.e4e import psp as jpsp
from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_torch.cli import infer_e4e
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.io import export, load_generator, rosinality
from stylemc_torch.models.e4e import editings, encoders, psp
from stylemc_torch.models.stylegan2 import generator as tgen
from tiny import TINY_E4E_LAYOUT
from torch_threads import one_torch_thread  # noqa: F401

ENC_TYPES = ("Encoder4Editing", "GradualStyleEncoder",
             "SingleStyleCodeEncoder")
STAGES = (0, 3, 7, 18)
GEN_KW = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2, conv_clamp=None, num_fp16_res=0)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _enc_params(enc_type, stylegan_size=256, layout=TINY_E4E_LAYOUT):
    return encoders.init_encoder_params(_gen(1), stylegan_size, enc_type,
                                        layout=layout, device="cpu")


@pytest.fixture(scope="module")
def x256():
    return (np.random.RandomState(2).randn(2, 3, 256, 256) * 0.5
            ).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_encoders():
    return {t: _enc_params(t) for t in ENC_TYPES}


@pytest.fixture(scope="module")
def jax_codes(tiny_encoders, x256):
    """JAX codes per (encoder type, stage), computed on first use; only
    Encoder4Editing reads the stage."""
    fns = {"Encoder4Editing": jenc.encoder4editing,
           "GradualStyleEncoder": jenc.gradual_style_encoder,
           "SingleStyleCodeEncoder": jenc.backbone_encoder_into_w}
    cache = {}

    def get(enc_type, stage):
        key = (enc_type, stage if enc_type == "Encoder4Editing" else None)
        if key not in cache:
            kw = {"layout": TINY_E4E_LAYOUT}
            if enc_type == "Encoder4Editing":
                kw["progressive_stage"] = stage
            fn = jax.jit(lambda p, x: fns[enc_type](p, x, 256, **kw))
            cache[key] = np.asarray(fn(params_to_numpy(
                tiny_encoders[enc_type]), x256))
        return cache[key]

    return get


def test_style_count_and_fpn_taps_match_jax():
    from stylemc_torch.models.arcface import ir_se_50_layout

    for size in (16, 32, 256, 1024):
        assert encoders.style_count(size) == jenc.style_count(size)
    assert encoders.fpn_tap_indices(ir_se_50_layout()) == (6, 20, 23)
    assert encoders.fpn_tap_indices(TINY_E4E_LAYOUT) == \
        jenc.fpn_tap_indices(TINY_E4E_LAYOUT)
    with pytest.raises(ValueError):
        encoders.fpn_tap_indices([(8, 8, 2), (8, 8, 1)])


@pytest.mark.parametrize("enc_type", ENC_TYPES)
@pytest.mark.parametrize("stage", STAGES)
def test_encoders_match_jax(tiny_encoders, jax_codes, x256, enc_type, stage):
    pp = psp.PSP(psp.PSPConfig(256, enc_type, encoder_layout=TINY_E4E_LAYOUT),
                 tiny_encoders[enc_type], tgen.GeneratorConfig(**GEN_KW), {})
    with torch.inference_mode():
        got = pp.encode(torch.from_numpy(x256), progressive_stage=stage)
    assert got.shape == (2, 14, 512)
    _close(got, jax_codes(enc_type, stage))
    if enc_type == "Encoder4Editing":
        # rows past the stage carry w0 alone; row 0 never takes a delta
        rows = got.numpy()
        for i in range(min(stage + 1, 14), 14):
            np.testing.assert_array_equal(rows[:, i], rows[:, 0])


def test_primitives_match_jax():
    rs = np.random.RandomState(3)
    for shape, size in (((1, 2, 8, 8), (16, 16)), ((2, 3, 5, 7), (9, 13))):
        x = rs.randn(*shape).astype(np.float32)
        y = rs.randn(*shape[:2], *size).astype(np.float32)
        _close(encoders.upsample_add(torch.from_numpy(x), torch.from_numpy(y)),
               jenc.upsample_add(x, y))
    lin = {"weight": rs.randn(8, 4).astype(np.float32),
           "bias": rs.randn(8).astype(np.float32)}
    z = rs.randn(3, 4).astype(np.float32)
    for lr_mul in (1.0, 0.5):
        _close(encoders.equal_linear(params_from_numpy(lin, "cpu"),
                                     torch.from_numpy(z), lr_mul),
               jenc.equal_linear(lin, z, lr_mul))
    head = params_to_numpy(_enc_params("Encoder4Editing")["styles"]["3"])
    feat = rs.randn(2, 64, 32, 32).astype(np.float32)
    _close(encoders.gradual_style_block(params_from_numpy(head, "cpu"),
                                        torch.from_numpy(feat), 32),
           jax.jit(lambda p, f: jenc.gradual_style_block(p, f, 32))(head,
                                                                   feat))


# ----------------------------------------------------------------------- pSp


@pytest.fixture(scope="module")
def psps():
    """(port PSP, JAX PSP) at stylegan_size 32 with the same weights. The
    JAX PSP's encode and decode are jitted once and shared by every test;
    its own __call__ does the latent mixing."""
    enc = _enc_params("Encoder4Editing", stylegan_size=32)
    dec = tgen.init_generator_params(_gen(2), tgen.GeneratorConfig(**GEN_KW),
                                     device="cpu")
    for bp in dec["synthesis"].values():  # exercise const noise
        for name in ("conv0", "conv1"):
            if name in bp:
                bp[name]["noise_strength"].fill_(0.2)
    la = (np.random.RandomState(4).randn(8, 512) * 0.1).astype(np.float32)
    tp = psp.PSP(psp.PSPConfig(32, encoder_layout=TINY_E4E_LAYOUT), enc,
                 tgen.GeneratorConfig(**GEN_KW), dec, torch.from_numpy(la))
    jp = jpsp.PSP(jpsp.PSPConfig(32, encoder_layout=TINY_E4E_LAYOUT),
                  params_to_numpy(enc), jgen.GeneratorConfig(**GEN_KW),
                  params_to_numpy(dec), la)
    plain = dataclasses.replace(jp)
    encode = jax.jit(lambda x: plain.encode(x))
    decode = jax.jit(lambda c: plain.decode(c))
    jp.encode = lambda x, progressive_stage=18: encode(x)
    jp.decode = lambda c, resize=True, noise_mode="const": decode(c)
    return tp, jp


def test_psp_encode_decode_match_jax(psps, x256):
    tp, jp = psps
    x = x256[:1]
    with torch.inference_mode():
        codes = tp.encode(torch.from_numpy(x))
        img = tp.decode(codes)
        img32 = tp.decode(codes, resize=False)
    want_codes = jp.encode(x)
    _close(codes, want_codes, rtol=1e-4, atol_rel=1e-4)
    assert img.shape == (1, 3, 256, 256) and img32.shape == (1, 3, 32, 32)
    _close(img, jp.decode(want_codes), rtol=1e-4, atol_rel=1e-4)
    # resize=False is the synthesis output that resize=True pools
    from stylemc_torch.utils.image import adaptive_avg_pool2d
    torch.testing.assert_close(adaptive_avg_pool2d(img32, 256, 256), img,
                               rtol=0, atol=0)


@pytest.mark.parametrize("mix", ["zero", "inject", "alpha"])
def test_psp_latent_mask_matches_jax(psps, x256, mix):
    tp, jp = psps
    x = x256[1:]
    inject = (np.random.RandomState(5).randn(1, 8, 512) * 0.3
              ).astype(np.float32)
    kw = {"latent_mask": [1, 5, 6], "return_latents": True}
    if mix != "zero":
        kw["inject_latent"] = inject
    if mix == "alpha":
        kw["alpha"] = 0.3
    tkw = dict(kw, inject_latent=torch.from_numpy(inject)) \
        if mix != "zero" else kw
    with torch.inference_mode():
        img, codes = tp(torch.from_numpy(x), **tkw)
    want_img, want_codes = jp(x, **kw)
    _close(codes, want_codes, rtol=1e-4, atol_rel=1e-4)
    _close(img, want_img, rtol=1e-4, atol_rel=1e-4)
    if mix == "zero":
        assert float(codes[:, [1, 5, 6]].abs().max()) == 0


# ------------------------------------------------------------ export / import


ROS_SIZE = 16  # rosinality widths (512 channels) at a small plane


@pytest.fixture(scope="module")
def ros_gen():
    """A rosinality-width generator (mapping depth 2), as numpy params with
    a non-zero w_avg and noise strengths."""
    cfg = dataclasses.replace(rosinality.config_for_rosinality(ROS_SIZE),
                              mapping_layers=2)
    params = tgen.init_generator_params(_gen(3), cfg, device="cpu")
    params["mapping"]["w_avg"].normal_(generator=_gen(4))
    for bp in params["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in bp:
                bp[name]["noise_strength"].fill_(0.1)
    return cfg, params_to_numpy(params)


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v)
        else:
            g = got[k].detach().cpu().numpy() if isinstance(
                got[k], torch.Tensor) else np.asarray(got[k])
            np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def _assert_pt_equal(a, b):
    """Two checkpoints hold the same keys and bit-equal tensors."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_pt_equal(a[k], b[k])
    else:
        assert a == b


def test_rosinality_export_and_import_match_jax(ros_gen, tmp_path):
    cfg, params = ros_gen
    jcfg = dataclasses.replace(jros.config_for_rosinality(ROS_SIZE),
                               mapping_layers=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tpath, jpath = str(tmp_path / "t.pt"), str(tmp_path / "j.pt")
    export.save_rosinality_pt(tpath, cfg, params_from_numpy(params, "cpu"))
    jexport.save_rosinality_pt(jpath, jcfg, params)
    _assert_pt_equal(torch.load(tpath, weights_only=True),
                     torch.load(jpath, weights_only=True))
    # the JAX-written file through the port's loader: the JAX loader's
    # params bit for bit, and the same synthesis
    tcfg, tparams = load_generator(jpath, device="cpu")
    jcfg2, jparams = jros.load_rosinality_pt(jpath)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg2)
    _assert_trees_equal(tparams, jparams)
    _assert_trees_equal(tparams, params)
    assert rosinality.infer_rosinality_size(
        torch.load(jpath, weights_only=True)["g_ema"]) == ROS_SIZE
    z = np.random.RandomState(6).randn(2, 512).astype(np.float32)
    want = jax.jit(lambda p, z: jgen.generate(p, jcfg2, z, 0.7))(jparams, z)
    with torch.inference_mode():
        got = tgen.generate(tparams, tcfg, torch.from_numpy(z),
                            truncation_psi=0.7)
    _close(got, want, rtol=1e-4, atol_rel=1e-4)
    with pytest.raises(ValueError, match="rosinality"):
        torch.save({"g_ema": {"x": torch.zeros(1)}}, str(tmp_path / "b.pt"))
        rosinality.load_rosinality_pt(str(tmp_path / "b.pt"))


def test_legacy_dest_pt_round_trip(ros_gen, tmp_path):
    from stylemc_torch.cli.legacy import main as legacy
    from stylemc_torch.io import save_native

    cfg, params = ros_gen
    src, dest = str(tmp_path / "g.npz"), str(tmp_path / "g.pt")
    save_native(src, cfg, params)
    r = CliRunner().invoke(legacy, ["--source", src, "--dest", dest])
    assert r.exit_code == 0, r.output
    tcfg, tparams = load_generator(dest, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    _assert_trees_equal(tparams, params)
    r = CliRunner().invoke(legacy, ["--source", src, "--dest",
                                    str(tmp_path / "g.bin")])
    assert r.exit_code != 0


@pytest.fixture(scope="module")
def e4e_ckpts(tmp_path_factory):
    """A full IR-SE-50 e4e checkpoint at stylegan_size 32 written by both
    packages from the same numpy weights: (dir, weights, port path, JAX
    path)."""
    d = tmp_path_factory.mktemp("e4e")
    enc = params_to_numpy(encoders.init_encoder_params(_gen(5), 32,
                                                       device="cpu"))
    dcfg = rosinality.config_for_rosinality(32)
    dec = params_to_numpy(tgen.init_generator_params(_gen(6), dcfg,
                                                     device="cpu"))
    la = (np.random.RandomState(7).randn(512) * 0.1).astype(np.float32)
    tpath, jpath = str(d / "t.pt"), str(d / "j.pt")
    export.save_e4e_pt(tpath, enc, dcfg, dec, la)
    jexport.save_e4e_pt(jpath, enc, jros.config_for_rosinality(32), dec, la)
    return d, (enc, dcfg, dec, la), tpath, jpath


def test_e4e_export_and_import_match_jax(e4e_ckpts):
    """The port writes JAX's file bit for bit, and reads JAX's file back
    into the weights JAX wrote, bit for bit."""
    _, (enc, dcfg, dec, la), tpath, jpath = e4e_ckpts
    t, j = (torch.load(p, weights_only=True, mmap=True)
            for p in (tpath, jpath))
    _assert_pt_equal(t, j)
    assert t["opts"] == {"stylegan_size": 32,
                         "encoder_type": "Encoder4Editing"}
    tp = psp.load_psp_from_checkpoint(jpath, 32, device="cpu")
    _assert_trees_equal(tp.encoder_params, enc)
    _assert_trees_equal(tp.decoder_params["synthesis"], dec["synthesis"])
    for i in range(dcfg.mapping_layers):
        _assert_trees_equal(tp.decoder_params["mapping"][f"fc{i}"],
                            dec["mapping"][f"fc{i}"])
    assert dataclasses.asdict(tp.decoder_cfg) == dataclasses.asdict(
        jros.config_for_rosinality(32))
    assert tp.cfg == psp.PSPConfig(32, "Encoder4Editing")
    np.testing.assert_array_equal(tp.latent_avg.numpy(),
                                  np.repeat(la[None], 8, axis=0))


def _photos(d, n):
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(8)
    for i in range(n):
        # smooth seeded images: a colour ramp plus noise
        ramp = np.linspace(0, 255, 256)[None, :, None] * rs.rand(1, 1, 3)
        img = np.clip(ramp + rs.randn(256, 256, 3) * 20, 0, 255)
        Image.fromarray(img.astype(np.uint8), "RGB").save(
            os.path.join(d, f"p{i}.png"))
    return d


def test_infer_e4e_matches_jax_cli(e4e_ckpts, monkeypatch):
    """Both CLIs on the same two photos at batch 2; the port's directory
    holds a third photo, so its last batch is padded by repeating it."""
    d, _, _, jpath = e4e_ckpts
    batches = []
    encode = psp.PSP.encode

    def spy(self, x, *a, **kw):
        batches.append(x.clone())
        return encode(self, x, *a, **kw)

    monkeypatch.setattr(psp.PSP, "encode", spy)
    outs = {}
    for name, cli, n, extra in (
            ("jax", jax_infer_e4e.main, 2, []),
            ("torch", infer_e4e.main, 3, ["--device", "cpu"])):
        out = str(d / name)
        r = CliRunner().invoke(cli, [
            "--images_dir", _photos(str(d / f"photos{n}"), n), "--ckpt",
            jpath, "--save_dir", out, "--stylegan_size", "32", "--batch",
            "2", "--save_images"] + extra, catch_exceptions=False)
        assert r.exit_code == 0, r.output
        outs[name] = out
    got = np.load(os.path.join(outs["torch"], "projected_w.npz"))["w"]
    want = np.load(os.path.join(outs["jax"], "projected_w.npz"))["w"]
    assert want.shape == (2, 8, 512) and got.shape == (3, 8, 512)
    _close(got[:2], want, rtol=1e-4, atol_rel=1e-4)
    for i in range(2):
        a, b = (np.asarray(Image.open(os.path.join(o, "inversions",
                                                   f"p{i}.png")))
                for o in (outs["torch"], outs["jax"]))
        assert a.shape == (256, 256, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert os.path.exists(os.path.join(outs["torch"], "inversions", "p2.png"))
    assert [b.shape[0] for b in batches] == [2, 2]
    torch.testing.assert_close(batches[1][1], batches[1][0], rtol=0, atol=0)
    assert np.isfinite(got).all()


def test_infer_e4e_align_matches_jax_cli(e4e_ckpts, tmp_path, monkeypatch):
    """--align: both CLIs FFHQ-align two photos from the landmark files
    (test_torch_landmarks.write_landmark_weights) before encoding; the same
    tolerances as without it."""
    from test_torch_landmarks import _photo, write_landmark_weights

    d, _, _, jpath = e4e_ckpts
    mtcnn_dir, mobilenet, _, _ = write_landmark_weights(str(tmp_path))
    monkeypatch.setenv("STYLEMC_MTCNN_DIR", mtcnn_dir)
    monkeypatch.setenv("STYLEMC_MOBILENET", mobilenet)
    photos = tmp_path / "photos"
    photos.mkdir()
    for i in range(2):
        Image.fromarray(_photo(128, seed=10 + i)).save(photos / f"p{i}.png")
    photos = str(photos)
    outs = {}
    for name, cli, extra in (("jax", jax_infer_e4e.main, []),
                             ("torch", infer_e4e.main, ["--device", "cpu"])):
        outs[name] = str(tmp_path / name)
        r = CliRunner().invoke(cli, [
            "--images_dir", photos, "--ckpt", jpath, "--save_dir",
            outs[name], "--stylegan_size", "32", "--batch", "2",
            "--align"] + extra, catch_exceptions=False)
        assert r.exit_code == 0, r.output
    got, want = (np.load(os.path.join(outs[n], "projected_w.npz"))["w"]
                 for n in ("torch", "jax"))
    assert got.shape == want.shape == (2, 8, 512)
    # the landmarks' fp32 noise (1e-4 of their values) moves the quad, so
    # the aligned photos differ by ±1 per uint8 here and there (held in
    # test_torch_landmarks.test_align_faces_cli_matches_jax)
    _close(got, want, rtol=1e-2, atol_rel=2e-3)
    # aligned and unaligned photos encode differently
    r = CliRunner().invoke(infer_e4e.main, [
        "--images_dir", photos, "--ckpt", jpath, "--save_dir",
        str(tmp_path / "plain"), "--stylegan_size", "32", "--batch", "2",
        "--device", "cpu"], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    plain = np.load(str(tmp_path / "plain" / "projected_w.npz"))["w"]
    assert np.abs(plain - got).max() > 1e-3


def test_serve_from_files_attaches_the_e4e_ckpt(e4e_ckpts):
    """BatchEditor.from_files(rosinality .pt, e4e_ckpt=...): the inverter
    is the checkpoint's encoder at the network's resolution; inverting is
    encode, then the editor's own w_to_s."""
    from stylemc_torch.serve import BatchEditor

    d, (_, dcfg, dec, _), tpath, _ = e4e_ckpts
    net = export.save_rosinality_pt(str(d / "decoder.pt"), dcfg, dec)
    ed = BatchEditor.from_files(net, e4e_ckpt=tpath, max_batch=1,
                                device="cpu")
    assert ed.has_inverter and ed._inverter.cfg.stylegan_size == 32
    assert ed._inverter.decoder_params == {}
    photo = np.random.RandomState(9).randint(0, 256, (1, 256, 256, 3),
                                             np.uint8)
    got = ed.invert_images(photo)
    ref = psp.load_psp_from_checkpoint(tpath, 32, device="cpu")
    with torch.inference_mode():
        x = torch.from_numpy(photo).permute(0, 3, 1, 2).float() / 127.5 - 1
        want = tgen.w_to_s(ed.params, ed.cfg, ref.encode(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------------ editings


def test_sefa_ganspace_interfacegan_match_jax():
    # a narrow w (64) keeps SeFa's eigen decomposition small
    cfg = tgen.GeneratorConfig(img_resolution=16, channel_base=256,
                               channel_max=32, mapping_layers=1, z_dim=64,
                               w_dim=64)
    tparams = tgen.init_generator_params(_gen(12), cfg, device="cpu")
    params = params_to_numpy(tparams)
    lat = (np.random.RandomState(9).randn(2, 6, 64)).astype(np.float32)
    for layers in ("all", [0, 2, 3]):
        ti, tv, te = editings.sefa_factorize(tparams, layers)
        ji, jv, je = jedit.sefa_factorize(params, layers)
        assert ti == ji
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(te, je)
    got = editings.apply_sefa(tparams, lat, indices=(1, 2), semantics=2,
                              num_samples=2, step=3)
    want = jedit.apply_sefa(params, lat, indices=(1, 2), semantics=2,
                            num_samples=2, step=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tl = torch.from_numpy(lat)
    d = np.random.RandomState(10).randn(1, 6, 64).astype(np.float32)
    _close(editings.apply_interfacegan(tl, torch.from_numpy(d), 1.5),
           jedit.apply_interfacegan(lat, d, 1.5))
    _close(editings.apply_interfacegan(tl, torch.from_numpy(d),
                                       factor_range=(-2, 2)),
           jedit.apply_interfacegan(lat, d, factor_range=(-2, 2)))
    rs = np.random.RandomState(11)
    pca = {"mean": rs.randn(64).astype(np.float32),
           "comp": rs.randn(4, 64).astype(np.float32),
           "std": rs.rand(4).astype(np.float32) + 0.5}
    edits = [(0, 1, 3, 2.0), (2, 0, 6, -1.0)]
    _close(editings.apply_ganspace(tl, pca, edits),
           jedit.apply_ganspace(lat, pca, edits))
