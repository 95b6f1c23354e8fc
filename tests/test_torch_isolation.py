"""stylemc_torch stands alone and never runs on the CPU unasked.

* Importing every module of the port loads no JAX and nothing of
  stylemc_tpu (checked in a fresh interpreter, and by a scan of the source).
* With no CUDA device, entry points without device="cpu" raise.
* The kernel wrappers have no silent path: a tensor that is neither on the
  CPU nor on CUDA raises, and a kernel build without a working nvcc raises
  with nvcc's output.
* On a machine with a card, B1 is held against its plain version and its
  gradient goes through B2, and B3/B4/B5 (the fused synthesis layer) are
  held against theirs, B3 and B5 also at ragged tilings (marked `cuda`;
  skip here).
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
from stylemc_torch.ops import setup_filter_np
from stylemc_torch.ops.kernels import build, modconv
from stylemc_torch.ops.kernels.upfirdn2d import (
    _canonical_taps, downsample2d_kernel, downsample2d_plain,
    upsample2d_kernel, upsample2d_plain)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "stylemc_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_stylemc_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'stylemc_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # 49 modules before the e4e slice, which adds 9; the landmarks stack
    # and align_faces add 12
    # the mapper and DeepLab slice adds 5; GAN evaluation, the warp tools
    # and LPIPS add 13; e4e training adds 10; data parallelism adds 4
    assert len(_modules()) >= 102
    for m in ("stylemc_torch.ops.kernels.modconv",
              "stylemc_torch.bench.fused_layer_ab",
              "stylemc_torch.bench.timing",
              "stylemc_torch.train.find_direction",
              "stylemc_torch.cli.find_direction",
              "stylemc_torch.models.arcface", "stylemc_torch.models.clip.model",
              "stylemc_torch.models.clip.tokenizer",
              "stylemc_torch.losses.clip_loss_nada",
              "stylemc_torch.utils.model_zoo", "stylemc_torch.io.torch_state",
              "stylemc_torch.io.rosinality", "stylemc_torch.io.export",
              "stylemc_torch.models.e4e.encoders",
              "stylemc_torch.models.e4e.psp",
              "stylemc_torch.models.e4e.editings",
              "stylemc_torch.data.images", "stylemc_torch.cli.infer_e4e",
              "stylemc_torch.losses.landmarks_loss", "stylemc_torch.ops.image",
              "stylemc_torch.models.mobilenet",
              "stylemc_torch.models.mtcnn", "stylemc_torch.models.mtcnn.nets",
              "stylemc_torch.models.mtcnn.detect", "stylemc_torch.native",
              "stylemc_torch.native.build", "stylemc_torch.cv",
              "stylemc_torch.cv.landmarks", "stylemc_torch.cv.align",
              "stylemc_torch.cli.align_faces",
              "stylemc_torch.models.mapper", "stylemc_torch.models.deeplab",
              "stylemc_torch.train.latent_mapper",
              "stylemc_torch.cli.train_latent_mapper",
              "stylemc_torch.cli.run_deeplab",
              "stylemc_torch.metrics", "stylemc_torch.metrics.scores",
              "stylemc_torch.metrics.feature_stats",
              "stylemc_torch.metrics.inception", "stylemc_torch.metrics.ppl",
              "stylemc_torch.metrics.lec", "stylemc_torch.metrics.metric_main",
              "stylemc_torch.cli.calc_metrics", "stylemc_torch.models.perceptual",
              "stylemc_torch.losses.lpips", "stylemc_torch.cv.warp",
              "stylemc_torch.models.mtcnn.visualize",
              "stylemc_torch.cli.warp_images",
              "stylemc_torch.train.ranger", "stylemc_torch.train.coach",
              "stylemc_torch.losses.w_norm", "stylemc_torch.losses.moco",
              "stylemc_torch.models.resnet",
              "stylemc_torch.models.e4e.discriminator",
              "stylemc_torch.data.configs", "stylemc_torch.io.numpy_pickle",
              "stylemc_torch.cli.train_e4e",
              "stylemc_torch.cli.calc_losses_on_images",
              "stylemc_torch.parallel", "stylemc_torch.parallel.mesh",
              "stylemc_torch.parallel.stats",
              "stylemc_torch.bench.dp_ranks"):
        assert m in _modules()


def test_source_scan_has_no_jax_or_stylemc_tpu_import():
    # import statements, and dynamic imports naming either package
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|optax|stylemc_tpu)\b"
        r"|import_module\(\s*['\"](jax|stylemc_tpu)"
        r"|__import__\(\s*['\"](jax|stylemc_tpu)", re.M)
    paths = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(paths) >= 20
    for path in paths:
        hits = [m.group(0) for m in pattern.finditer(path.read_text())]
        assert not hits, (path, hits)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from stylemc_torch.io import load_generator, save_native
    from stylemc_torch.models.stylegan2.generator import (
        GeneratorConfig, init_generator_params)
    from stylemc_torch.cli.find_direction import main as find_direction_main
    from stylemc_torch.cli.infer_e4e import main as infer_e4e_main
    from stylemc_torch.models.clip import CLIP_CONFIGS, init_clip_params
    from stylemc_torch.models.e4e.encoders import init_encoder_params
    from stylemc_torch.models.e4e.psp import load_psp_from_checkpoint
    from stylemc_torch.cli.align_faces import main as align_faces_main
    from stylemc_torch.cv.landmarks import default_landmarker
    from stylemc_torch.models.mobilenet import init_mobilenet_gdconv_params
    from stylemc_torch.models.mtcnn.detect import MTCNN
    from stylemc_torch.models.mtcnn.nets import init_net_params
    from stylemc_torch.models.deeplab import (
        Segmenter, default_segmenter, init_deeplab_params,
        save_deeplab_checkpoint)
    from stylemc_torch.models.mapper import init_mapper_params
    from stylemc_torch.cli.run_deeplab import main as run_deeplab_main
    from stylemc_torch.cli.train_latent_mapper import (
        main as train_latent_mapper_main)
    from stylemc_torch.serve import BatchEditor
    from stylemc_torch.utils.model_zoo import load_arcface, load_clip_models
    from stylemc_torch.cli.calc_metrics import main as calc_metrics_main
    from stylemc_torch.cli.warp_images import main as warp_images_main
    from stylemc_torch.losses.lpips import init_lpips_params
    from stylemc_torch.metrics import MetricOptions, calc_metric, compute_ppl
    from stylemc_torch.metrics.inception import init_inception_params
    from stylemc_torch.metrics.scores import (
        kid_from_features, precision_recall_from_features)
    from stylemc_torch.cli.calc_losses_on_images import (
        main as calc_losses_main)
    from stylemc_torch.cli.train_e4e import main as train_e4e_main
    from stylemc_torch.models.e4e.discriminator import (
        init_discriminator_params)
    from stylemc_torch.models.e4e.psp import PSP, PSPConfig
    from stylemc_torch.models.resnet import init_resnet50_params
    from stylemc_torch.train.coach import Coach, CoachOptions

    cfg = GeneratorConfig(img_resolution=8, channel_base=64, channel_max=8,
                          mapping_layers=1)
    params = init_generator_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    net = str(tmp_path / "net.npz")
    save_native(net, cfg, params)
    parser = init_deeplab_params(torch.Generator().manual_seed(0),
                                 layers=(1, 1, 1, 1), width=8)
    ckpt = str(tmp_path / "deeplab_model.pth")
    save_deeplab_checkpoint(ckpt, parser)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: BatchEditor(cfg, params),
                 lambda: BatchEditor.from_files(net),
                 lambda: load_generator(net),
                 lambda: init_generator_params(torch.Generator(), cfg),
                 lambda: load_arcface(allow_random_init=True),
                 lambda: load_clip_models("small", allow_random_init=True),
                 lambda: init_clip_params(torch.Generator(),
                                          CLIP_CONFIGS["ViT-B/32"]),
                 lambda: BatchEditor.from_files(net, e4e_ckpt="e4e.pt"),
                 lambda: load_psp_from_checkpoint("e4e.pt"),
                 lambda: init_encoder_params(torch.Generator()),
                 lambda: init_net_params(torch.Generator(), "pnet"),
                 lambda: init_mobilenet_gdconv_params(torch.Generator()),
                 lambda: MTCNN.from_weights_dir(str(tmp_path)),
                 lambda: default_landmarker(str(tmp_path), net),
                 lambda: init_mapper_params(torch.Generator()),
                 lambda: BatchEditor.from_files(net, mapper="m.pth"),
                 lambda: Segmenter(parser),
                 lambda: default_segmenter(ckpt),
                 lambda: init_clip_params(torch.Generator(),
                                          CLIP_CONFIGS["RN50"]),
                 lambda: init_inception_params(torch.Generator()),
                 lambda: init_lpips_params(torch.Generator(), "vgg"),
                 lambda: compute_ppl(None, None, None, 4, num_samples=1),
                 lambda: calc_metric("is50k", opts=MetricOptions(
                     gen_params=params, gen_cfg=cfg)),
                 lambda: kid_from_features(np.ones((4, 2)), np.ones((4, 2)),
                                           device="cuda"),
                 lambda: precision_recall_from_features(
                     np.ones((4, 2)), np.ones((4, 2)), device="cuda"),
                 lambda: Coach(CoachOptions(stylegan_size=8),
                               PSP(PSPConfig(8), {}, cfg, params), {},
                               lambda: None),
                 lambda: init_discriminator_params(torch.Generator()),
                 lambda: init_resnet50_params(torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # so do the e4e inversion, alignment, face-parsing, metrics, warp, e4e
    # training and image-loss CLIs
    for cli, args in ((infer_e4e_main, ["--images_dir", str(tmp_path),
                                        "--ckpt", "e4e.pt"]),
                      (align_faces_main, ["--images_dir", str(tmp_path),
                                          "--out_dir", str(tmp_path / "a")]),
                      (run_deeplab_main, ["--dataset_root", str(tmp_path),
                                          "--ckpt", ckpt]),
                      (calc_metrics_main, ["--network", net, "--metrics",
                                           "is50k", "--allow_random_init"]),
                      (warp_images_main, ["--indir", str(tmp_path),
                                          "--outdir", str(tmp_path / "w")]),
                      (train_e4e_main, ["--exp_dir", str(tmp_path / "e"),
                                        "--source_root", str(tmp_path),
                                        "--stylegan_weights", net,
                                        "--allow_random_init"]),
                      (calc_losses_main, ["--data_path", str(tmp_path),
                                          "--gt_path", str(tmp_path),
                                          "--allow_random_init"])):
        r = CliRunner().invoke(cli, args)
        assert isinstance(r.exception, RuntimeError), r.output
        assert "device='cpu'" in str(r.exception)
    # the training CLIs default to cuda and raise before loading anything
    s_file = str(tmp_path / "s.npz")
    np.savez(s_file, s=np.zeros((4, 26, 512), np.float32))
    for cli in (find_direction_main, train_latent_mapper_main):
        r = CliRunner().invoke(cli, [
            "--network", net, "--s_input", s_file, "--outdir",
            str(tmp_path / "out"), "--allow_random_init"])
        assert isinstance(r.exception, RuntimeError), r.output
        assert "device='cpu'" in str(r.exception)
    # explicit CPU still works
    assert BatchEditor(cfg, params, device="cpu").device.type == "cpu"


def test_kernel_wrapper_has_no_silent_path():
    f = setup_filter_np([1, 3, 3, 1])
    x = torch.empty((1, 3, 4, 4), device="meta")
    before = upsample2d_kernel.launches
    with pytest.raises(ValueError, match="device"):
        upsample2d_kernel(x, f)
    assert upsample2d_kernel.launches == before


def test_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "b")
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    monkeypatch.setenv("CUDACXX", str(tmp_path / "missing-nvcc"))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: str(p).startswith(str(tmp_path)) and
                        os.path.exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library("k", [src])

    fake = tmp_path / "fake-nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDACXX", str(fake))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.build_library("k", [src])
    assert not list((tmp_path / "b").rglob("*.so"))


def test_build_caches_by_content(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "b")
    calls = tmp_path / "calls"
    fake = tmp_path / "fake-nvcc"
    # writes the file named after -o, and counts its invocations
    fake.write_text('#!/bin/sh\necho x >> "%s"\nwhile [ "$1" != "-o" ]; do '
                    'shift; done\necho lib > "$2"\n' % calls)
    fake.chmod(0o755)
    monkeypatch.setenv("CUDACXX", str(fake))
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    lib1 = build.build_library("k", [src])
    assert build.build_library("k", [src]) == lib1 and lib1.exists()
    src.write_text("// v2\n")
    lib2 = build.build_library("k", [src])
    assert lib2 != lib1
    assert calls.read_text().count("x") == 2
    assert (lib1.parent / "build.log").exists()
    assert "-gencode" in (lib1.parent / "build.log").read_text()


def test_chip_smoke_yardstick_and_bound():
    taps = (0.1, 0.5, 0.9, 0.3)  # asymmetric: pins the tap orientation
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 6, 10)
                         .astype(np.float32))
    weight = chip_smoke.library_weight(taps, 5, "cpu")
    torch.testing.assert_close(chip_smoke.library_upsample(x, weight),
                               upsample2d_plain(x, taps), rtol=0, atol=1e-6)
    ms, by = chip_smoke.upsample_bound((16, 3, 128, 128))
    assert by == "bytes"
    # 3.1 MB in + 12.6 MB out at 3.35 TB/s ≈ 4.7 µs
    assert abs(ms - 20 * 16 * 3 * 128 * 128 / 3.35e12 * 1e3) < 1e-12
    assert 4.6e-3 < ms < 4.8e-3


def test_chip_smoke_modconv_bound_and_yardstick():
    from stylemc_torch.bench.fused_layer_ab import layer_shapes

    # FFHQ-256's 256² conv1 at batch 4: 77.3 GFLOP against 0.27 GB, done
    # in 3xTF32 on the tensor cores (three TF32 products per product at
    # 495 TFLOP/s), the fp32 FMA time (67 TFLOP/s) beside it
    b = chip_smoke.modconv_bound("modconv_fwd", 4, 128, 128, 256, 256)
    flop = 2 * 4 * 128 * 128 * 9 * 256 * 256
    assert b["bound_by"] == "operations" and b["flop"] == flop
    assert abs(b["bound_ms"] - 3 * flop / 495e12 * 1e3) < 1e-12
    assert abs(b["fp32_fma_bound_ms"] - flop / 67e12 * 1e3) < 1e-12
    # B5 over the seven conv1 layers: 1.5612 ms of operations
    ops = sum(chip_smoke.modconv_bound("modconv_bwd_weight", 4, c, c, r,
                                       r)["ops_ms"]
              for c, r in layer_shapes())
    assert abs(ops - 1.5612) < 1e-4
    for name in chip_smoke.MODCONV_KERNELS:
        # at 4x4 the [512, 512, 3, 3] weight (9.4 MB) outweighs 0.3 GFLOP
        assert chip_smoke.modconv_bound(name, 4, 512, 512, 4, 4)[
            "bound_by"] == "bytes"
        assert chip_smoke.modconv_bound(name, 4, 512, 512, 8, 8)[
            "bound_by"] == "operations"
    # B5's library yardstick computes the plain version's function
    rs = np.random.RandomState(0)
    x, dy, y = (torch.from_numpy(rs.randn(*shape).astype(np.float32))
                for shape in ((2, 5, 6, 7), (2, 3, 6, 7), (2, 3, 6, 7)))
    s = torch.from_numpy(rs.rand(2, 5).astype(np.float32) + 0.5)
    d = torch.from_numpy(rs.rand(2, 3).astype(np.float32) + 0.5)
    gain = float(np.sqrt(2))
    want = modconv.fused_layer_bwd_weight_plain(dy, y * 200, x, s, d, gain,
                                                256.0)
    dz_d = dy * modconv._act_grad(y * 200, gain, 256.0) * d[:, :, None, None]
    got = torch.nn.grad.conv2d_weight(x * s[:, :, None, None], (3, 5, 3, 3),
                                      dz_d, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_modconv_wrapper_has_no_silent_path():
    x = torch.empty((1, 2, 4, 4), device="meta")
    w = torch.empty((3, 2, 3, 3), device="meta")
    s = torch.empty((1, 2), device="meta")
    noise = torch.empty((4, 4), device="meta")
    b = torch.empty((3,), device="meta")
    before = modconv.launch_fwd.launches
    with pytest.raises(ValueError, match="device"):
        modconv.fused_modulated_layer(x, w, s, noise, b)
    assert modconv.launch_fwd.launches == before


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.cuda
def test_upsample_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = setup_filter_np([1, 3, 3, 1])
    taps = _canonical_taps(f, 4.0, False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in chip_smoke.CHAIN_SHAPES + chip_smoke.EXTRA_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        before = upsample2d_kernel.launches
        got = upsample2d_kernel(x, f)
        assert upsample2d_kernel.launches == before + 1
        torch.testing.assert_close(got, upsample2d_plain(x, taps), rtol=0,
                                   atol=chip_smoke.KERNEL_TOL)
    # under autograd the backward is B2 (downsample2d_kernel), launched
    x = torch.randn((1, 3, 4, 4), generator=gen, device="cuda",
                    requires_grad=True)
    g = torch.randn((1, 3, 8, 8), generator=gen, device="cuda")
    before_up = upsample2d_kernel.launches
    before_down = downsample2d_kernel.launches
    dx, = torch.autograd.grad(upsample2d_kernel(x, f), x, g)
    assert upsample2d_kernel.launches == before_up + 1
    assert downsample2d_kernel.launches == before_down + 1
    torch.testing.assert_close(
        dx, downsample2d_plain(g, taps[::-1]), rtol=0,
        atol=chip_smoke.KERNEL_TOL)


@pytest.mark.cuda
def test_downsample_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f = setup_filter_np([1, 3, 3, 1])
    taps = _canonical_taps(f, 1.0, False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in chip_smoke.DOWN_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        before = downsample2d_kernel.launches
        got = downsample2d_kernel(x, f)
        assert downsample2d_kernel.launches == before + 1
        torch.testing.assert_close(got, downsample2d_plain(x, taps), rtol=0,
                                   atol=chip_smoke.KERNEL_TOL)
    # under autograd the backward is B1 with the reversed taps, launched
    x = torch.randn((1, 3, 8, 8), generator=gen, device="cuda",
                    requires_grad=True)
    g = torch.randn((1, 3, 4, 4), generator=gen, device="cuda")
    before_up = upsample2d_kernel.launches
    dx, = torch.autograd.grad(downsample2d_kernel(x, f), x, g)
    assert upsample2d_kernel.launches == before_up + 1
    torch.testing.assert_close(dx, upsample2d_plain(g, taps[::-1]), rtol=0,
                               atol=chip_smoke.KERNEL_TOL)


@pytest.mark.cuda
def test_modconv_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stylemc_torch.bench.fused_layer_ab import CLAMP, GAIN, make_inputs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = modconv
    for case, n, ci, co, h, w, scale in chip_smoke.MODCONV_EXTRA + [
            ("b32", 4, 512, 512, 32, 32, 1.0)]:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=3)
        x, wt, s, noise, b = (inp[k] for k in ("x", "w", "s", "noise", "b"))
        x = x * scale
        d, _ = mc.dcoefs(wt, s)
        y_p = mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN, CLAMP)
        y_k = mc.launch_fwd(x, wt, s, d, noise, b, GAIN, CLAMP)
        scale_y = float(mc.fused_layer_fwd_plain(x, wt, s, d, noise, b, GAIN,
                                                 None).abs().max())
        assert float((y_k - y_p).abs().max()) <= \
            chip_smoke.MODCONV_FWD_TOL * max(1.0, scale_y), case
        dy = torch.randn_like(y_p)
        got = mc.launch_bwd_data(dy, y_p, x, wt, s, d, noise, b, GAIN, CLAMP)
        want = mc.fused_layer_bwd_data_plain(dy, y_p, x, wt, s, d, noise, b,
                                             GAIN, CLAMP)
        got += (mc.launch_bwd_weight(dy, y_p, x, s, d, GAIN, CLAMP),)
        want += (mc.fused_layer_bwd_weight_plain(dy, y_p, x, s, d, GAIN,
                                                 CLAMP),)
        for g, p in zip(got, want):
            assert float((g - p).norm() / p.norm()) <= \
                chip_smoke.MODCONV_REL_L2, case
    # B5 where its tiling is ragged: CO 8 < one fragment's 16 rows (the odd
    # shape above), CI and CO not multiples of the block tile, a 4x4 plane,
    # and W % 4 != 0 and a misaligned x (the kernel's 4-byte copies)
    for case, n, ci, co, h, w, misaligned in chip_smoke.MODCONV_DW_RAGGED:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=4)
        xr, wr, sr = inp["x"], inp["w"], inp["s"]
        if misaligned:
            xr = torch.empty(xr.numel() + 1, device="cuda")[1:].view_as(
                xr).copy_(xr)
            assert xr.data_ptr() % 16 != 0
        dr, _ = mc.dcoefs(wr, sr)
        yr = mc.fused_layer_fwd_plain(xr, wr, sr, dr, inp["noise"], inp["b"],
                                      GAIN, CLAMP)
        dyr = torch.randn_like(yr)
        before = mc.launch_bwd_weight.launches
        got = mc.launch_bwd_weight(dyr, yr, xr, sr, dr, GAIN, CLAMP)
        assert mc.launch_bwd_weight.launches == before + 1
        want = mc.fused_layer_bwd_weight_plain(dyr, yr, xr, sr, dr, GAIN,
                                               CLAMP)
        assert float((got - want).norm() / want.norm()) <= \
            chip_smoke.MODCONV_REL_L2, case
    # B3 where its tiling is ragged, split over CI on the 4x4 plane, and on
    # its 4-byte copies
    for case, n, ci, co, h, w, misaligned in chip_smoke.MODCONV_FWD_RAGGED:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=6)
        xr, wr, sr = inp["x"], inp["w"], inp["s"]
        if misaligned:
            xr = torch.empty(xr.numel() + 1, device="cuda")[1:].view_as(
                xr).copy_(xr)
        dr, _ = mc.dcoefs(wr, sr)
        want = mc.fused_layer_fwd_plain(xr, wr, sr, dr, inp["noise"],
                                        inp["b"], GAIN, CLAMP)
        before = mc.launch_fwd.launches
        got = mc.launch_fwd(xr, wr, sr, dr, inp["noise"], inp["b"], GAIN,
                            CLAMP)
        assert mc.launch_fwd.launches == before + 1
        assert float((got - want).abs().max()) <= \
            chip_smoke.MODCONV_FWD_TOL * max(1.0, float(want.abs().max())), \
            case
    # B4 where its tiling is ragged, split over CO on the small planes, on
    # its 4-byte copies, and with dy, y and x as views at a 4-byte offset
    for case, n, ci, co, h, w, misaligned in chip_smoke.MODCONV_DX_RAGGED:
        inp = make_inputs(n, ci, co, h, w, "cuda", seed=7)
        xr, wr, sr = inp["x"], inp["w"], inp["s"]
        dr, _ = mc.dcoefs(wr, sr)
        yr = mc.fused_layer_fwd_plain(xr, wr, sr, dr, inp["noise"], inp["b"],
                                      GAIN, CLAMP)
        dyr = torch.randn_like(yr)
        if misaligned:
            dyr, yr, xr = (torch.empty(t.numel() + 1, device="cuda")[1:]
                           .view_as(t).copy_(t) for t in (dyr, yr, xr))
            assert all(t.data_ptr() % 16 != 0 for t in (dyr, yr, xr))
        before = mc.launch_bwd_data.launches
        got = mc.launch_bwd_data(dyr, yr, xr, wr, sr, dr, inp["noise"],
                                 inp["b"], GAIN, CLAMP)
        assert mc.launch_bwd_data.launches == before + 1
        want = mc.fused_layer_bwd_data_plain(dyr, yr, xr, wr, sr, dr,
                                             inp["noise"], inp["b"], GAIN,
                                             CLAMP)
        for name, g, p in zip(("dx", "ds_direct", "dd", "db"), got, want):
            assert float((g - p).norm() / p.norm()) <= \
                chip_smoke.MODCONV_REL_L2, (case, name)
    # autograd through the Function: B3, B4 and B5 once each
    counters = [mc.launch_fwd, mc.launch_bwd_data, mc.launch_bwd_weight]
    before = [c.launches for c in counters]
    leaves = [t.clone().requires_grad_(True) for t in (x, wt, s, b)]
    y = mc.fused_modulated_layer(leaves[0], leaves[1], leaves[2], noise,
                                 leaves[3], gain=GAIN, clamp=CLAMP)
    torch.autograd.grad(y, leaves, torch.randn_like(y))
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
