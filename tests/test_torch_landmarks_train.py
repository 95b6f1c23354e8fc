"""The port's landmarks trainer against the JAX package's, on the CPU:
`prepare_landmarks_refs`, the logging-only metric,
`find_direction(landmarks_in_graph=True)` and the CLI's --landmarks_grad,
on test_torch_find_direction.py's `setup` and test_torch_landmarks.py's
landmark weights.

Tolerances: boxes within 1e-3 px (MTCNN's float boxes carry the nets'
fp32 noise); the landmarks of the same boxes rtol 1e-4 and atol
1e-4·max|ref| (1e-2 from each side's own boxes: a 1e-3 px shift of a box
moves them by ~1e-3 of the crop); the metric rtol 1e-4; loss history
rtol 1e-4 and direction atol 1e-4 (test_find_direction_matches_jax's
figures), the CLI's direction equal to the direct call's.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import torch
from click.testing import CliRunner

from stylemc_tpu.cv import landmarks as jlm
from stylemc_tpu.models.clip import FallbackTokenizer as JaxTokenizer
from stylemc_tpu.models.mtcnn import detect as jdet
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.cv import landmarks
from stylemc_torch.models.clip import FallbackTokenizer
from stylemc_torch.models.mtcnn import detect as tdet
from stylemc_torch.models.mtcnn import nets as tnets
from stylemc_torch.models.stylegan2.generator import synthesis
from stylemc_torch.train import find_direction as tfd
from test_torch_find_direction import (  # noqa: F401
    _kw, _resume, cli_files, setup, tiny_arcface_clis)
from test_torch_landmarks import (  # noqa: F401
    LANDMARKS_COEF, NETS, _close, _gen, landmarkers, weights)
from torch_threads import one_torch_thread  # noqa: F401

jfd = importlib.import_module("stylemc_tpu.train.find_direction")


def test_landmarks_refs_and_metric_match_jax(landmarkers, setup):  # noqa: F811
    jl, tl = landmarkers
    jax_side, torch_side, styles = setup
    gen_cfg, gen_params, _, _ = jax_side
    cfg, gp, _, _ = torch_side
    kw = _kw(landmarks_in_graph=True)
    jb, jlm_ = jfd.prepare_landmarks_refs(
        gen_params, gen_cfg, jnp.asarray(styles[:4]),
        jfd.FindDirectionConfig(**kw), jl, chunk=4)
    tb, tlm = tfd.prepare_landmarks_refs(
        gp, cfg, torch.from_numpy(styles[:4]), tfd.FindDirectionConfig(**kw),
        tl, chunk=4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-3)
    # the landmarks from the same boxes (a 1e-3 px shift of a box moves
    # them by ~1e-3 of the crop)
    with torch.no_grad():
        img = synthesis(gp, cfg, torch.from_numpy(styles[:4]),
                        until_k=tfd.until_k_for_resolution(32))
        same = tfd.crop_landmarks(tl.params, img,
                                  torch.from_numpy(np.asarray(jb)))
    _close(same.numpy(), jlm_, rtol=1e-4, atol_rel=1e-4)
    _close(tlm.numpy(), jlm_, rtol=1e-2, atol_rel=1e-2)

    direction = _resume(scale=0.5)
    jm = jfd.make_landmarks_metric_fn(gen_params, gen_cfg,
                                      jfd.FindDirectionConfig(**_kw()), jl)
    tm = tfd.make_landmarks_metric_fn(gp, cfg, tfd.FindDirectionConfig(**_kw()),
                                      tl)
    want = jm(jnp.asarray(direction), jnp.asarray(styles[:2]))
    got = tm(torch.from_numpy(direction), torch.from_numpy(styles[:2]))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_find_direction_landmarks_in_graph_matches_jax(weights,
                                                      setup):  # noqa: F811
    """With MTCNN nets that find no face, both sides take the full-frame
    box for every render, so they crop the same boxes. The coefficient is
    small: ReLU masks that flip under fp32 noise put ~1e-3 relative L2 on
    MobileNet's input gradient in either package (against float64), which
    the default 25 would carry into the direction past 1e-4.

    Even so the direction after two steps sits at fp32's floor: JAX's own
    run moves by up to ~1.1e-4 when the styles move by one float32 ulp
    (a relative 1.2e-7, either sign). The port is held to JAX within 1e-4,
    or within that perturbed control's reading where it is larger, and the
    control must read at least a third of 1e-4, so the bound is not slack.
    (JAX's float64 is no reference here: its generator casts each block's
    input to float32.)"""
    mb = weights[3]
    plain = {w: params_to_numpy(tnets.init_net_params(_gen(i), w,
                                                      device="cpu"))
             for i, w in enumerate(NETS)}
    jl = jlm.Landmarker(jdet.MTCNN(*(plain[w] for w in NETS)), mb)
    tl = landmarks.Landmarker(
        tdet.MTCNN(*(params_from_numpy(plain[w], "cpu") for w in NETS)),
        params_from_numpy(mb, "cpu"))
    jax_side, torch_side, styles = setup
    gen_cfg, gen_params, clips, arc = jax_side
    cfg, gp, tclips, tarc = torch_side
    resume = _resume()
    kw = _kw(clip_type="small", landmarks_in_graph=True,
             landmarks_loss_coef=LANDMARKS_COEF)
    seen = {}

    def callback(it, loss, aux, lr, grad_norm, direction):
        seen.update(aux)

    jd, jinfo = jfd.find_direction(
        gen_params, gen_cfg, styles[:8], clips, arc,
        jfd.FindDirectionConfig(**kw), tokenizer=JaxTokenizer(),
        resume_direction=resume, landmarker=jl)
    td, tinfo = tfd.find_direction(
        gp, cfg, styles[:8], tclips, tarc, tfd.FindDirectionConfig(**kw),
        tokenizer=FallbackTokenizer(), resume_direction=resume,
        landmarker=tl, callback=callback)
    assert tinfo["iterations"] == jinfo["iterations"] == 2
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-4)
    control = 0.0
    for eps in (1.2e-7, -1.2e-7):
        jd_eps, _ = jfd.find_direction(
            gen_params, gen_cfg,
            (styles[:8] * np.float32(1 + eps)).astype(np.float32), clips,
            arc, jfd.FindDirectionConfig(**kw), tokenizer=JaxTokenizer(),
            resume_direction=resume, landmarker=jl)
        control = max(control, float(np.abs(np.asarray(jd_eps)
                                            - np.asarray(jd)).max()))
    assert control >= 1e-4 / 3
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=max(1e-4, control))
    assert np.isfinite(seen["landmarks_loss"]) and seen["landmarks_loss"] > 0
    # the term carries gradient to Δs
    fdc = tfd.FindDirectionConfig(**kw)
    s4 = torch.from_numpy(styles[:4])
    refs = tfd.prepare_landmarks_refs(gp, cfg, s4, fdc, tl)
    bundles = tfd.make_clip_bundles(fdc, tclips, FallbackTokenizer())
    feats = tfd.precompute_original_features(gp, cfg, s4, bundles, tarc, fdc)
    delta = torch.from_numpy(resume[:, tfd.TRAINABLE]).requires_grad_(True)
    _, aux = tfd.make_loss_fn(gp, cfg, bundles, tarc, fdc,
                              mobilenet_params=tl.params)(
        delta, s4, *feats, refs)
    g, = torch.autograd.grad(aux["landmarks_loss"], delta)
    assert g.abs().max() > 0


def test_cli_landmarks_grad_and_metric(weights, cli_files,  # noqa: F811
                                       tiny_arcface_clis, monkeypatch):
    """--landmarks_grad writes the direct call's direction; without it the
    logging-only metric is computed from the landmark files and printed
    (the tiny ArcFace patched into the CLI's loader)."""
    from stylemc_torch.cli.find_direction import main
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.clip import SimpleTokenizer
    from stylemc_torch.utils.model_zoo import load_arcface, load_clip_models

    d, path, _, _ = weights
    root, pkl, s_file, r_file, env = cli_files
    for k, v in {**env, "STYLEMC_MTCNN_DIR": d,
                 "STYLEMC_MOBILENET": path}.items():
        monkeypatch.setenv(k, v)
    common = ["--network", pkl, "--s_input", s_file, "--text_prompt",
              "a smiling face", "--resolution", "32", "--n_epochs", "1",
              "--batch_size", "4", "--resume", r_file, "--device", "cpu",
              "--landmarks_loss_coef", str(LANDMARKS_COEF)]
    out = str(root / "lm_grad")
    r = CliRunner().invoke(main, common + ["--outdir", out,
                                           "--landmarks_grad"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    got = np.load(os.path.join(out, "direction_a_smiling_face.npz"))["s"]
    cfg, params = load_generator(pkl, device="cpu")
    clips, tok = load_clip_models("double", device="cpu")
    assert isinstance(tok, SimpleTokenizer)
    want, _ = tfd.find_direction(
        params, cfg, np.load(s_file)["s"], clips, load_arcface(device="cpu"),
        tfd.FindDirectionConfig(text_prompt="a smiling face", resolution=32,
                                n_epochs=1, batch_size=4,
                                landmarks_loss_coef=LANDMARKS_COEF,
                                landmarks_in_graph=True),
        tokenizer=tok, resume_direction=np.load(r_file)["s"],
        landmarker=landmarks.default_landmarker(device="cpu"))
    np.testing.assert_array_equal(got, want.numpy())

    r = CliRunner().invoke(main, common + ["--outdir", str(root / "lm")],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    line = [x for x in r.output.splitlines() if "landmarks loss:" in x][-1]
    assert float(line.split("landmarks loss:")[1].split(",")[0]) > 0
