"""The port's find_direction against the JAX package's, on the CPU (fp32).

The `setup` of tests/test_find_direction.py: tiny_gen(32) from the JAX
initialiser, the tiny CLIP towers and ArcFace, 12 items, batch 4, one epoch
(3 steps). Both sides start from the same `resume_direction`, a seeded
N(0,1)·0.5 on the trainable rows: from a ~1e-3 start the StyleMC term
normalises a near-zero feature difference, which amplifies the frameworks'
summation-order noise. Loss history agrees to rtol 1e-4 and the final
direction to atol 1e-4; one NADA loss value and its gradient to atol 1e-5.
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from fabricate import fabricate_clip_dir
from stylemc_tpu.models.clip import FallbackTokenizer as JaxTokenizer
from stylemc_tpu.models.stylegan2.generator import mapping, w_to_s
from stylemc_tpu.utils import model_zoo as jzoo
from stylemc_torch.convert import params_from_numpy
from stylemc_torch.models.clip import FallbackTokenizer
from stylemc_torch.models.stylegan2.generator import (
    GeneratorConfig, S_TRAINABLE_SPACE_CHANNELS)
from stylemc_torch.train import find_direction as tfd
from stylemc_torch.utils import model_zoo as tzoo
from test_pickle_loader import fabricate_pkl
from test_torch_perception import write_arcface_pth
from tiny import TINY_ARCFACE_LAYOUT, tiny_arcface, tiny_clip_models, tiny_gen
from torch_threads import one_torch_thread  # noqa: F401

# the package's __init__ exports the function under the module's name
jfd = importlib.import_module("stylemc_tpu.train.find_direction")
TRAINABLE = list(S_TRAINABLE_SPACE_CHANNELS)
FROZEN = [i for i in range(26) if i not in TRAINABLE]


def _resume(seed=5, scale=0.5):
    d = np.zeros((1, 26, 512), np.float32)
    rng = np.random.RandomState(seed)
    for row in TRAINABLE:
        d[:, row] = rng.randn(512).astype(np.float32) * scale
    return d


@pytest.fixture(scope="module")
def setup():
    gen_cfg, gen_params = tiny_gen(resolution=32)
    clip_models = tiny_clip_models()
    arcface = tiny_arcface()
    z = jax.random.normal(jax.random.PRNGKey(9), (12, gen_cfg.z_dim))
    styles = np.asarray(w_to_s(gen_params, gen_cfg,
                               mapping(gen_params, gen_cfg, z)))
    jax_side = (gen_cfg, gen_params, clip_models, arcface)
    torch_side = (
        GeneratorConfig(img_resolution=32, channel_base=2048, channel_max=64,
                        mapping_layers=2),
        params_from_numpy(gen_params, "cpu"),
        {k: (cfg, params_from_numpy(p, "cpu"))
         for k, (cfg, p) in clip_models.items()},
        params_from_numpy(arcface, "cpu"))
    return jax_side, torch_side, styles


def _kw(**kw):
    base = dict(resolution=32, batch_size=4, n_epochs=1, learning_rate=0.5,
                clip_type="double", arcface_layout=TINY_ARCFACE_LAYOUT,
                seed=0)
    base.update(kw)
    return base


def _run_torch(torch_side, styles, resume=None, callback=None, **kw):
    cfg, gp, clips, arc = torch_side
    return tfd.find_direction(gp, cfg, styles, clips, arc,
                              tfd.FindDirectionConfig(**_kw(**kw)),
                              tokenizer=FallbackTokenizer(),
                              resume_direction=resume, callback=callback)


@pytest.fixture(scope="module")
def small_run(setup):
    """The port's clip_type 'small' run from `_resume()`, which three
    tests hold other runs against: computed once."""
    _, torch_side, styles = setup
    return _run_torch(torch_side, styles, _resume(), clip_type="small")


def test_schedules_match_jax():
    for it in (1, 7, 33):
        assert tfd.cosine_lr(1.5, it, 33) == jfd.cosine_lr(1.5, it, 33)
    for sched in ("cosine", "constant"):
        tk = tfd.FindDirectionConfig(lr_schedule=sched)
        jk = jfd.FindDirectionConfig(lr_schedule=sched)
        assert [tfd.schedule_lr(tk, i, 10) for i in range(1, 11)] == \
            [jfd.schedule_lr(jk, i, 10) for i in range(1, 11)]
    for res in (32, 256, 1024):
        assert tfd.until_k_for_resolution(res) == \
            jfd.until_k_for_resolution(res)
    with pytest.raises(ValueError):
        tfd.schedule_lr(tfd.FindDirectionConfig(lr_schedule="step"), 1, 10)


@pytest.mark.parametrize("clip_type", ["small", "double"])
def test_find_direction_matches_jax(setup, small_run, clip_type):
    jax_side, torch_side, styles = setup
    resume = _resume()
    gen_cfg, gen_params, clips, arc = jax_side
    jd, jinfo = jfd.find_direction(
        gen_params, gen_cfg, styles, clips, arc,
        jfd.FindDirectionConfig(**_kw(clip_type=clip_type)),
        tokenizer=JaxTokenizer(), resume_direction=resume)
    td, tinfo = small_run if clip_type == "small" else \
        _run_torch(torch_side, styles, resume, clip_type=clip_type)
    assert tinfo["iterations"] == jinfo["iterations"] == 3
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-4)
    td = td.numpy()
    np.testing.assert_allclose(td, np.asarray(jd), rtol=0, atol=1e-4)
    assert np.abs(td[:, FROZEN]).max() == 0
    assert np.abs(td - resume).max() > 1e-3  # it moved
    assert set(tinfo) >= {"history", "time", "iterations",
                          "first_step_time", "steady_ms_per_step"}


@pytest.mark.parametrize("loss_type", ["nada", "nada_global"])
def test_nada_loss_value_and_gradient_match_jax(setup, loss_type):
    jax_side, torch_side, styles = setup
    kw = _kw(clip_type="double", clip_loss_type=loss_type)
    gen_cfg, gen_params, clips, arc = jax_side
    jfdc = jfd.FindDirectionConfig(**kw)
    jb = jfd.make_clip_bundles(jfdc, clips, JaxTokenizer())
    jid, jclip = jfd.precompute_original_features(
        gen_params, gen_cfg, jnp.asarray(styles[:4]), jb, arc, jfdc)
    jloss = jfd.make_loss_fn(gen_params, gen_cfg, jb, arc, jfdc)
    delta = _resume()[:, TRAINABLE]
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(delta), jnp.asarray(styles[:4]), jid, jclip)

    cfg, gp, tclips, tarc = torch_side
    tfdc = tfd.FindDirectionConfig(**kw)
    tb = tfd.make_clip_bundles(tfdc, tclips, FallbackTokenizer())
    tid, tclip = tfd.precompute_original_features(
        gp, cfg, torch.from_numpy(styles[:4]), tb, tarc, tfdc)
    d = torch.from_numpy(delta).requires_grad_(True)
    tl, _ = tfd.make_loss_fn(gp, cfg, tb, tarc, tfdc)(
        d, torch.from_numpy(styles[:4]), tid, tclip)
    tg, = torch.autograd.grad(tl, d)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-5)


def test_dispatch_options_run_the_same_loop(setup, small_run):
    _, torch_side, styles = setup
    resume = _resume()
    plain, pinfo = small_run
    for kw in ({"steps_per_dispatch": 3}, {"split_step": True}):
        got, info = _run_torch(torch_side, styles, resume, clip_type="small",
                               **kw)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        assert info["history"] == pinfo["history"]


def test_fresh_start_callback_cadence_and_frozen_rows(setup):
    _, torch_side, styles = setup
    calls = []

    def callback(it, loss, aux, lr, grad_norm, direction):
        calls.append(it)
        assert set(aux) == {"clip_loss", "identity_loss", "l2_loss",
                            "landmarks_loss"}
        assert aux["landmarks_loss"] == 0.0
        assert direction.shape == (1, 26, 512)
        assert np.isfinite([loss, lr, grad_norm]).all()

    # batch 1: 12 steps; callbacks at every 10th iteration and the last
    d, info = _run_torch(torch_side, styles, callback=callback,
                         clip_type="small", batch_size=1)
    assert calls == [10, 12] and info["iterations"] == 12
    d = d.numpy()
    assert np.abs(d[:, FROZEN]).max() == 0
    assert np.abs(d[:, TRAINABLE]).max() > 0
    # the fresh start is N(0,1)·1e-3 from a torch.Generator seeded with seed
    d0, _ = _run_torch(torch_side, styles, clip_type="small", n_epochs=0)
    want = torch.randn((1, 8, 512), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(d0[:, TRAINABLE], want * 1e-3, rtol=0, atol=0)


def test_remat_and_bf16_policies(setup, small_run):
    import dataclasses

    _, torch_side, styles = setup
    cfg, gp, clips, arc = torch_side
    resume = _resume()
    plain, pinfo = small_run
    # remat recomputes each block in the backward pass: the same numbers
    remat = (dataclasses.replace(cfg, remat=True), gp, clips, arc)
    got, info = _run_torch(remat, styles, resume, clip_type="small")
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-6)
    np.testing.assert_allclose(info["history"], pinfo["history"], rtol=1e-6)
    # bf16 synthesis and bf16 perception: the ToRGB chain stays float32
    # (the kernels take nothing else), and the run stays finite
    bf16 = (dataclasses.replace(cfg, low_precision_dtype="bfloat16"), gp,
            clips, arc)
    got, info = _run_torch(bf16, styles, resume, clip_type="small",
                           perception_dtype="bfloat16")
    assert np.isfinite(info["history"]).all()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(info["history"], pinfo["history"], rtol=0.1)


def test_landmarks_in_graph_refusals_match_jax(setup):
    """landmarks_in_graph needs a landmarker and refuses split_step, as
    JAX's find_direction does (its asserts)."""
    _, torch_side, styles = setup
    with pytest.raises(ValueError, match="needs a landmarker"):
        _run_torch(torch_side, styles, landmarks_in_graph=True)
    cfg, gp, clips, arc = torch_side
    with pytest.raises(ValueError, match="split_step"):
        tfd.find_direction(
            gp, cfg, styles, clips, arc,
            tfd.FindDirectionConfig(**_kw(landmarks_in_graph=True,
                                          split_step=True)),
            tokenizer=FallbackTokenizer(), landmarker=object())


# ------------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory, setup):
    jax_side, _, styles = setup
    root = tmp_path_factory.mktemp("fd")
    gen_cfg, gen_params, _, _ = jax_side
    pkl = fabricate_pkl(root, gen_cfg, gen_params)
    clip_dir = fabricate_clip_dir(str(root / "clip"))
    arc = str(root / "model_ir_se50.pth")
    write_arcface_pth(arc)
    s_file, r_file = str(root / "input.npz"), str(root / "resume.npz")
    np.savez(s_file, s=styles[:8])
    np.savez(r_file, s=_resume())
    env = {"STYLEMC_CLIP_DIR": clip_dir, "STYLEMC_ARCFACE": arc,
           "STYLEMC_CLIP_BPE": os.path.join(clip_dir,
                                            "bpe_simple_vocab_16e6.txt.gz")}
    return root, pkl, s_file, r_file, env


@pytest.fixture
def tiny_arcface_clis(setup, monkeypatch):
    """Both CLIs with the tiny ArcFace of `setup` (its layout in every
    FindDirectionConfig they make) in place of IR-SE-50."""
    arc = setup[0][3]
    monkeypatch.setattr(jzoo, "load_arcface", lambda *a, **kw: arc)
    monkeypatch.setattr(tzoo, "load_arcface", lambda *a, device=None, **kw:
                        params_from_numpy(arc, device))
    for mod in (jfd, tfd):
        monkeypatch.setattr(mod, "FindDirectionConfig", functools.partial(
            mod.FindDirectionConfig, arcface_layout=TINY_ARCFACE_LAYOUT))


def test_cli_writes_the_direct_calls_direction(cli_files, monkeypatch):
    from stylemc_torch.cli.find_direction import main
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.clip import SimpleTokenizer
    from stylemc_torch.utils.model_zoo import load_arcface, load_clip_models

    root, pkl, s_file, r_file, env = cli_files
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outdir = str(root / "out")
    r = CliRunner().invoke(main, [
        "--network", pkl, "--s_input", s_file, "--outdir", outdir,
        "--text_prompt", "a smiling face", "--resolution", "32",
        "--n_epochs", "1", "--batch_size", "4", "--resume", r_file,
        "--device", "cpu", "--allow_random_init", "--steps_per_dispatch",
        "epoch", "--trace_dir", str(root / "trace")], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert "steps_per_dispatch=epoch -> 2 steps per dispatch" in r.output
    assert os.path.getsize(root / "trace" / "find_direction_trace.json") > 0
    assert "Iteration 2, gradient norm:" in r.output
    assert "landmarks metric reported as 0" in r.output
    got = np.load(os.path.join(outdir, "direction_a_smiling_face.npz"))["s"]
    assert got.shape == (1, 26, 512) and got.dtype == np.float32
    assert os.path.exists(os.path.join(outdir, "wandb_log.jsonl"))

    cfg, params = load_generator(pkl, device="cpu")
    clips, tok = load_clip_models("double", device="cpu")
    assert isinstance(tok, SimpleTokenizer)
    want, _ = tfd.find_direction(
        params, cfg, np.load(s_file)["s"], clips, load_arcface(device="cpu"),
        tfd.FindDirectionConfig(text_prompt="a smiling face", resolution=32,
                                n_epochs=1, batch_size=4),
        tokenizer=tok, resume_direction=np.load(r_file)["s"])
    np.testing.assert_array_equal(got, want.numpy())


def test_run_logger_writes_jsonl_and_never_starts_wandb(tmp_path,
                                                       monkeypatch):
    import json
    import sys
    import types

    from stylemc_torch.utils.logging import RunLogger

    fake = types.ModuleType("wandb")

    def init(**kwargs):
        raise AssertionError("wandb.init was called")

    fake.init = init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    logger = RunLogger("p", config={"lr": 1.5}, outdir=str(tmp_path / "o"))
    logger.log({"loss": torch.tensor(0.5), "note": object}, step=10)
    logger.finish()
    lines = [json.loads(x) for x in
             (tmp_path / "o" / "wandb_log.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "init" and lines[0]["config"] == {"lr": 1.5}
    assert lines[1]["step"] == 10 and lines[1]["loss"] == 0.5
    assert isinstance(lines[1]["note"], str)


@pytest.mark.parametrize("args,match", [
    (["--text_prompts", "a|b", "--landmarks_grad"],
     "--landmarks_grad is not supported with --text_prompts"),
    (["--negative_text_prompts", "c|d"],
     "--negative_text_prompts requires --text_prompts"),
    (["--text_prompts", "a|b", "--negative_text_prompts", "c"],
     "count must match --text_prompts"),
    (["--text_prompts", "a|b", "--resume", "DIR"],
     "requires --text_prompts --batch_prompts"),
])
def test_cli_refuses_what_jax_refuses(cli_files, args, match):
    """The port's CLI and JAX's refuse the same flag combinations, with
    the same words, before anything is loaded."""
    from stylemc_torch.cli.find_direction import main
    from stylemc_tpu.cli.find_direction import main as jax_main

    root, pkl, s_file, _, _ = cli_files
    args = [str(root) if a == "DIR" else a for a in args]
    for cli, extra in ((main, ["--device", "cpu"]), (jax_main, [])):
        r = CliRunner().invoke(cli, ["--network", pkl, "--s_input", s_file,
                                     "--outdir", str(root / "x")]
                               + args + extra)
        assert r.exit_code != 0 and match in r.output, r.output
