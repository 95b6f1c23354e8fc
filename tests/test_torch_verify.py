"""The weights verification harness (`python -m stylemc_torch verify`)
against the JAX package's (`stylemc_tpu/cli/verify_weights.py`), on the
CPU, on the same fabricated files.

Both CLIs run every check on a seeded 32 px network: the NVIDIA `.pkl`, a
TF1 pickle, an e4e `.pt`, a CLIP dir, an IR-SE-50 `.pth` (the port's seeded
network written in the reference's names), an Inception `.pth`, a DeepLab
and a MobileNet state dict. Their reports must hold the same checks with
the same `ok`, integer details equal and real ones within the tolerances
below, and the same exit code. The golden renders cross the packages (JAX
writes, the port reads: max_abs ≤ 1), and a failing check exits 1 in both.
The Inception FID split and the direction check run in
`test_torch_verify_fid.py` and `test_torch_verify_direction.py`, on this
module's files.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fabricate import fabricate_clip_dir, fabricate_e4e_pt
from stylemc_tpu.cli.verify_weights import main as jax_verify
from stylemc_tpu.models.stylegan2 import discriminator as jdisc
from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_torch.cli.verify_weights import _resize_matrix, resize_bilinear
from stylemc_torch.cli.verify_weights import main as torch_verify
from stylemc_torch.io.torch_state import state_from_params
from stylemc_torch.metrics import inception as tinc
from stylemc_torch.models import arcface as tarc
from stylemc_torch.models import deeplab as tdl
from stylemc_torch.models import mobilenet as tmb
from test_pickle_loader import fabricate_pkl
from test_tf_legacy import (_install_fake_tflib, fabricate_tf_discriminator,
                            fabricate_tf_generator)
from torch_threads import one_torch_thread  # noqa: F401

RES = 32
# real-valued report details: (absolute, relative) tolerance between the
# packages; the values are rounded to 2-4 decimals in the report
REAL_TOL = {"uint8_std": (0.011, 0), "text_direction_norm": (1e-4, 1e-3),
            "cross_seed_cosine": (1e-4, 0), "codes_std": (1e-4, 1e-3),
            "fid_same_distribution": (1e-3, 1e-3),
            "psnr_db": (0.011, 0), "cosine_mean": (1e-3, 0),
            "cosine_min": (1e-3, 0), "threshold_db": (0, 0),
            "threshold": (0, 0)}


def _save_state(path, state):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state.items()}, path)
    return path


def write_files(d, parts):
    """The seeded 32 px network's `.pkl` and, by name in `parts`, the other
    files of a verify run: "tf", "e4e", "clip", "arcface", "inception",
    "deeplab", "mobilenet"."""
    cfg = jgen.GeneratorConfig(img_resolution=RES, channel_base=2048,
                               channel_max=64, mapping_layers=2)
    out = {"dir": d, "env": {}, "network": fabricate_pkl(
        d, cfg, jgen.init_generator_params(jax.random.PRNGKey(0), cfg))}
    gen = torch.Generator().manual_seed
    if "tf" in parts:
        Network = _install_fake_tflib()
        tf_cfg = jgen.GeneratorConfig(img_resolution=RES, channel_base=2048,
                                      channel_max=64, mapping_layers=2,
                                      conv_clamp=None, num_fp16_res=0)
        out["tf_network"] = os.path.join(d, "tf_net.pkl")
        with open(out["tf_network"], "wb") as f:
            pickle.dump((fabricate_tf_generator(
                Network, tf_cfg, jgen.init_generator_params(
                    jax.random.PRNGKey(4), tf_cfg)),
                fabricate_tf_discriminator(
                    Network, RES, jdisc.init_discriminator_params(
                        jax.random.PRNGKey(5), size=RES)),
                fabricate_tf_generator(
                    Network, tf_cfg, jgen.init_generator_params(
                        jax.random.PRNGKey(4), tf_cfg))), f)
    if "e4e" in parts:
        out["e4e"] = fabricate_e4e_pt(os.path.join(d, "e4e.pt"),
                                      stylegan_size=RES)
    if "clip" in parts:
        out["clip_dir"] = fabricate_clip_dir(os.path.join(d, "clip"),
                                             resolution=64)
        out["env"]["STYLEMC_CLIP_BPE"] = os.path.join(
            out["clip_dir"], "bpe_simple_vocab_16e6.txt.gz")
    if "arcface" in parts:
        out["arcface"] = _save_state(
            os.path.join(d, "model_ir_se50.pth"), state_from_params(
                tarc.params_from_torch_state,
                tarc.init_backbone_params(gen(1), device="cpu")))
    if "inception" in parts:
        out["inception"] = _save_state(
            os.path.join(d, "inception.pth"), state_from_params(
                tinc.params_from_torch_state,
                tinc.init_inception_params(gen(2), device="cpu")))
    # the flat state-dict layout the JAX harness reads: DeepLab at full
    # ResNet-101 depth (its reader's), narrow; MobileNet's 'module.' names
    if "deeplab" in parts:
        out["deeplab"] = _save_state(
            os.path.join(d, "deeplab_model.pth"), tdl.params_to_torch_state(
                tdl.init_deeplab_params(gen(3), width=8)))
    if "mobilenet" in parts:
        out["mobilenet"] = os.path.join(d, "mobilenet.pth")
        torch.save(tmb.params_to_torch_state(
            tmb.init_mobilenet_gdconv_params(gen(4), device="cpu")),
            out["mobilenet"])
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(str(tmp_path_factory.mktemp("verify")),
                       ("tf", "e4e", "clip", "arcface", "deeplab",
                        "mobilenet"))


def _run(cli, files, report, args, device=True):
    path = os.path.join(files["dir"], report)
    argv = list(args) + ["--report", path]
    if device:
        argv += ["--device", "cpu"]
    res = CliRunner().invoke(cli, argv, env=files["env"],
                             catch_exceptions=False)
    with open(path) as f:
        return res, json.load(f)


def _compare_details(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _compare_details(g, w, f"{where}/{k}")
        elif isinstance(w, float) and not isinstance(w, bool):
            atol, rtol = REAL_TOL[k]
            assert abs(g - w) <= atol + rtol * abs(w), (where, k, g, w)
        else:
            assert g == w, (where, k, g, w)


def _compare_reports(got, want):
    assert got["all_ok"] == want["all_ok"]
    assert got["n_checks"] == want["n_checks"]
    assert list(got["checks"]) == list(want["checks"])
    for name, w in want["checks"].items():
        g = got["checks"][name]
        assert g["ok"] == w["ok"] and g["requested"] == w["requested"], name
        assert ("error" in g) == ("error" in w), (name, g, w)
        if "details" in w:
            _compare_details(g["details"], w["details"], name)


def test_every_check_matches_jax(files):
    """Every check but the Inception FID split (`test_torch_verify_fid.py`)
    and the direction (`test_torch_verify_direction.py`), which run in
    files of their own so that the suite's workers share them."""
    golden = {p: os.path.join(files["dir"], f"golden_{p}.npz")
              for p in ("jax", "torch")}
    common = ["--network", files["network"],
              "--tf_network", files["tf_network"], "--e4e", files["e4e"],
              "--clip_dir", files["clip_dir"], "--arcface", files["arcface"],
              "--deeplab", files["deeplab"],
              "--mobilenet", files["mobilenet"], "--seeds", "0-3"]
    jr, jrep = _run(jax_verify, files, "jax.json",
                    common + ["--write_golden_renders", golden["jax"]],
                    device=False)
    tr, trep = _run(torch_verify, files, "torch.json",
                    common + ["--write_golden_renders", golden["torch"]])
    assert tr.exit_code == jr.exit_code == 0, (tr.output, jr.output)
    assert trep["all_ok"] and jrep["all_ok"]
    assert list(trep["checks"]) == [
        "generator", "tf_generator", "clip", "arcface", "e4e", "deeplab",
        "mobilenet_landmarks"]
    _compare_reports(trep, jrep)
    # the golden renders cross the packages: JAX's file read by the port
    tr2, rep = _run(torch_verify, files, "cross.json",
                    ["--network", files["network"], "--seeds", "0-3",
                     "--golden_renders", golden["jax"]])
    assert tr2.exit_code == 0, tr2.output
    det = rep["checks"]["golden_renders"]["details"]
    assert det["max_abs"] <= 1 and det["threshold_db"] == 30.0
    g, w = np.load(golden["torch"]), np.load(golden["jax"])
    assert np.abs(g["images"].astype(int) - w["images"]).max() <= 1
    np.testing.assert_array_equal(g["seeds"], w["seeds"])
    assert float(g["trunc"]) == float(w["trunc"])


def test_failing_check_exits_1_in_both(files):
    """A golden set that is not the network's renders fails its PSNR
    threshold: exit 1, all_ok false, in both packages."""
    bad = os.path.join(files["dir"], "bad_golden.npz")
    np.savez(bad, images=np.full((4, RES, RES, 3), 7, np.uint8),
             seeds=np.arange(4), trunc=0.7)
    args = ["--network", files["network"], "--seeds", "0-3",
            "--golden_renders", bad]
    jr, jrep = _run(jax_verify, files, "jax_bad.json", args, device=False)
    tr, trep = _run(torch_verify, files, "torch_bad.json", args)
    assert tr.exit_code == jr.exit_code == 1
    assert not trep["all_ok"] and not jrep["all_ok"]
    _compare_reports(trep, jrep)


def test_port_reads_the_wrapped_checkpoint_layouts(files, tmp_path):
    """The reference DeepLab and MobileNet checkpoints wrap their names in
    {'state_dict': {'module.' + name}}: the port's checks read that layout
    too (the files `default_segmenter` and `default_landmarker` read)."""
    deeplab = str(tmp_path / "deeplab_wrapped.pth")
    tdl.save_deeplab_checkpoint(deeplab, tdl.init_deeplab_params(
        torch.Generator().manual_seed(3), layers=(1, 1, 1, 1), width=32))
    mobilenet = str(tmp_path / "mobilenet.pth.tar")
    torch.save({"state_dict": tmb.params_to_torch_state(
        tmb.init_mobilenet_gdconv_params(torch.Generator().manual_seed(4),
                                         device="cpu"))}, mobilenet)
    tr, rep = _run(torch_verify, files, "wrapped.json",
                   ["--network", files["network"], "--seeds", "0-1",
                    "--deeplab", deeplab, "--mobilenet", mobilenet])
    assert tr.exit_code == 0, tr.output
    assert rep["checks"]["deeplab"]["ok"]
    assert rep["checks"]["mobilenet_landmarks"]["details"][
        "landmarks_shape"] == [1, 136]


@pytest.mark.parametrize("size_in, size_out", [(32, 256), (256, 224),
                                               (64, 64), (1024, 256)])
def test_resize_matches_jax_image_resize(size_in, size_out):
    x = np.random.RandomState(size_in).randn(2, 3, size_in, size_in).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (2, 3, size_out, size_out),
                                       "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size_out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert _resize_matrix(size_in, size_out).shape == (size_out, size_in)


def test_verify_raises_without_cuda(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(torch_verify, ["--network", files["network"],
                                            "--report", os.path.join(
                                                files["dir"], "x.json")])
    assert res.exit_code != 0
    assert "no CUDA device" in str(res.exception)
