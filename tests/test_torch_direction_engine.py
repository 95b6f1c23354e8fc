"""The port's prompt sweeps (DirectionEngine) against the JAX package's, on
the CPU (fp32), on test_torch_find_direction.py's `setup` (tiny generator,
CLIP towers and ArcFace, 12 items).

Both sides start from the same direction (`resume_direction(s)`, a seeded
N(0,1)·0.5 on the trainable rows): the fresh Δs is drawn by jax.random in
one and a torch.Generator in the other. Tolerances:

* `optimize` against JAX's: loss history rtol 1e-4, direction atol 1e-4
  (test_find_direction_matches_jax's figures);
* `optimize_batch`, one step, against JAX's vmapped step: atol 1e-5; the
  whole run against JAX's: atol 1e-4, the serial figure (JAX's own test
  holds its batched run to its serial one at cosine > 0.9999 and norms
  rtol 1e-3); against the port's serial `optimize`: the same;
* the sweep CLI's files against JAX's CLI's: atol 1e-4 (both CLIs on the
  tiny ArcFace, patched into their model loaders).

The prompt axis is folded into the image batch: one synthesis call a step
renders every prompt's images.
"""

import importlib
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from stylemc_tpu.cli import find_direction as jax_cli
from stylemc_tpu.models.clip import FallbackTokenizer as JaxTokenizer
from stylemc_torch.cli import find_direction as torch_cli
from stylemc_torch.models.clip import FallbackTokenizer
from stylemc_torch.train import find_direction as tfd
from test_torch_find_direction import (  # noqa: F401
    _kw, _resume, cli_files, setup, tiny_arcface_clis)
from torch_threads import one_torch_thread  # noqa: F401

jfd = importlib.import_module("stylemc_tpu.train.find_direction")
PROMPTS = ["a smiling face", "an old face"]
NEG = "a face"


def _fdc(mod, **kw):
    return mod.FindDirectionConfig(**_kw(**{
        "clip_type": "small", "text_prompt": PROMPTS[0],
        "negative_text_prompt": NEG, **kw}))


def _engines(setup, n_items=12, with_jax=True, **kw):  # noqa: F811
    """(JAX's engine or None, the port's) on the first n_items styles."""
    jax_side, torch_side, styles = setup
    gen_cfg, gen_params, clips, arc = jax_side
    cfg, gp, tclips, tarc = torch_side
    j = jfd.DirectionEngine(gen_params, gen_cfg, styles[:n_items], clips, arc,
                            _fdc(jfd, **kw), tokenizer=JaxTokenizer()) \
        if with_jax else None
    t = tfd.DirectionEngine(gp, cfg, styles[:n_items], tclips, tarc,
                            _fdc(tfd, **kw), tokenizer=FallbackTokenizer())
    return j, t


@pytest.fixture(scope="module")
def engines(setup):  # noqa: F811
    """Both packages' engines on the 12 items, built (and precomputed)
    once for the tests that run the default loss on them."""
    return _engines(setup)


@pytest.fixture(scope="module")
def serial(engines):
    """The port's serial `optimize` of a prompt from `_resume(seed)`,
    computed once per (prompt, seed)."""
    runs = {}

    def get(prompt, seed):
        if (prompt, seed) not in runs:
            runs[prompt, seed] = engines[1].optimize(
                prompt, resume_direction=_resume(seed))
        return runs[prompt, seed]

    return get


@pytest.mark.parametrize("loss_type", ["default", "nada"])
def test_optimize_matches_jax(setup, engines, serial,  # noqa: F811
                              loss_type):
    j, t = engines if loss_type == "default" else \
        _engines(setup, clip_loss_type=loss_type)
    resume = _resume()
    # the second prompt swaps the anchors under the same precompute
    for prompt in PROMPTS if loss_type == "default" else PROMPTS[:1]:
        jd, jinfo = j.optimize(prompt, resume_direction=resume)
        td, tinfo = serial(prompt, 5) if loss_type == "default" else \
            t.optimize(prompt, resume_direction=resume)
        assert tinfo["iterations"] == jinfo["iterations"] == 3
        np.testing.assert_allclose(tinfo["history"], jinfo["history"],
                                   rtol=1e-4)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-4)
        assert np.abs(td.numpy() - resume).max() > 1e-3


def test_optimize_is_find_direction(setup):  # noqa: F811
    """The engine's run of a prompt is find_direction's, number for
    number, fresh start included; a second prompt reuses the precompute."""
    _, torch_side, styles = setup
    cfg, gp, tclips, tarc = torch_side
    _, t = _engines(setup, n_items=8, with_jax=False)
    calls = []

    def callback(it, loss, aux, lr, direction):
        calls.append(it)
        assert direction.shape == (1, 26, 512)

    d_eng, info = t.optimize(PROMPTS[0], callback=callback)
    d_ref, ref = tfd.find_direction(gp, cfg, styles[:8], tclips, tarc,
                                    _fdc(tfd),
                                    tokenizer=FallbackTokenizer())
    torch.testing.assert_close(d_eng, d_ref, rtol=0, atol=0)
    assert info["history"] == ref["history"] and calls == []
    d2, _ = t.optimize(PROMPTS[1], negative_text_prompt="a sad face")
    assert (d2 - d_eng).abs().max() > 0


def test_optimize_batch_one_step_matches_jax(setup):  # noqa: F811
    """One step (4 items, batch 4) of both prompts from two different
    starts."""
    j, t = _engines(setup, n_items=4)
    starts = [_resume(5), _resume(6)]
    jd, jinfo = j.optimize_batch(PROMPTS, resume_directions=starts)
    td, tinfo = t.optimize_batch(PROMPTS, resume_directions=starts)
    assert td.shape == (2, 1, 26, 512) and tinfo["iterations"] == 1
    np.testing.assert_allclose(tinfo["history"], jinfo["history"],
                               rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def test_optimize_batch_matches_jax_and_the_serial_run(engines, serial,
                                                       monkeypatch):
    """Both prompts from seeded directions (JAX draws its fresh start
    itself): the batched run against JAX's and against each prompt's
    serial run."""
    j, t = engines
    starts = [_resume(5), _resume(6)]
    renders = []
    synthesis = tfd.synthesis

    def counting(params, cfg, styles, **kw):
        renders.append(styles.shape[0])
        return synthesis(params, cfg, styles, **kw)

    monkeypatch.setattr(tfd, "synthesis", counting)
    seen = []
    td, tinfo = t.optimize_batch(
        PROMPTS, resume_directions=starts,
        callback=lambda it, losses, aux, lr, dirs: seen.append(len(losses)))
    monkeypatch.setattr(tfd, "synthesis", synthesis)
    # one synthesis call a step, of both prompts' batches
    assert renders == [2 * 4] * 3 and tinfo["history"].shape == (2, 3)
    assert seen == []  # every 10th iteration only
    jd, jinfo = j.optimize_batch(PROMPTS, resume_directions=starts)
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)
    for p, prompt in enumerate(PROMPTS):
        np.testing.assert_allclose(
            td[p].numpy(), serial(prompt, 5 + p)[0].numpy(), rtol=0,
            atol=1e-4)
    # the prompts part ways
    a, b = (td[p].numpy().ravel() - starts[p].ravel() for p in range(2))
    assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) < 0.99


def test_optimize_batch_fresh_start_and_resume_directions(setup):  # noqa: F811
    """A None entry starts fresh, as the serial run does; a direction
    entry resumes from it."""
    _, t = _engines(setup, n_items=4, with_jax=False)
    d = _resume(7)
    got, _ = t.optimize_batch(PROMPTS, resume_directions=[d, None])
    torch.testing.assert_close(got[0], t.optimize(PROMPTS[0],
                                                  resume_direction=d)[0],
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], t.optimize(PROMPTS[1])[0], rtol=0,
                               atol=1e-5)


def test_engine_refuses_what_jax_refuses(setup):  # noqa: F811
    _, torch_side, styles = setup
    cfg, gp, tclips, tarc = torch_side
    with pytest.raises(ValueError, match="landmarks_in_graph"):
        tfd.DirectionEngine(gp, cfg, styles[:4], tclips, tarc,
                            _fdc(tfd, landmarks_in_graph=True))
    _, t = _engines(setup, n_items=4, with_jax=False)
    # a mesh is a parallel.DataMesh (test_torch_parallel.py runs them)
    with pytest.raises(TypeError, match="DataMesh"):
        t.optimize_batch(PROMPTS, mesh=object())
    with pytest.raises(ValueError, match="negative prompts"):
        t.optimize_batch(PROMPTS, negative_text_prompts=[NEG])
    with pytest.raises(ValueError, match="resume directions"):
        t.optimize_batch(PROMPTS, resume_directions=[None])


# ------------------------------------------------------------------------ CLI


def _run(cli, args, extra=()):
    r = CliRunner().invoke(cli.main, list(args) + list(extra),
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def _load(outdir, name):
    return np.load(os.path.join(outdir, name))["s"]


def test_resolve_zoo_resume_matches_jax(tmp_path):
    d = np.zeros((1, 26, 512), np.float32)
    np.savez(tmp_path / "direction_a_smiling_face.npz", s=d + 1)
    np.savez(tmp_path / "direction_last_an_old_face.npz", s=d + 3)
    np.savez(tmp_path / "one.npz", s=d + 2)
    (tmp_path / "empty").mkdir()
    for resume in (None, str(tmp_path), str(tmp_path / "one.npz"),
                   str(tmp_path / "empty")):
        got = torch_cli._resolve_zoo_resume(resume, PROMPTS)
        want = jax_cli._resolve_zoo_resume(resume, PROMPTS)
        assert (got is None) == (want is None)
        if got is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_sweep_cli_matches_jax_cli(cli_files, tiny_arcface_clis,  # noqa: F811
                                   monkeypatch):
    """--text_prompts --batch_prompts from one resume file, then again from
    the first run's directory; and the serial sweep."""
    root, pkl, s_file, r_file, env = cli_files
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    common = ["--network", pkl, "--s_input", s_file, "--resolution", "32",
              "--n_epochs", "1", "--batch_size", "4", "--allow_random_init",
              "--text_prompts", "|".join(PROMPTS),
              "--negative_text_prompts", "a face|a young face"]
    tags = [p.replace(" ", "_") for p in PROMPTS]
    outs = {}
    for name, cli, extra in (("jax", jax_cli, ["--no-data_parallel"]),
                             ("torch", torch_cli, ["--device", "cpu"])):
        first, second = (str(root / f"sweep_{name}{i}") for i in (1, 2))
        out = _run(cli, common + ["--outdir", first, "--batch_prompts",
                                  "--resume", r_file], extra)
        assert "2 prompts in one" in out
        out = _run(cli, common + ["--outdir", second, "--batch_prompts",
                                  "--resume", first], extra)
        assert f"Resuming 'an old face' from {first}" in out
        outs[name] = (first, second)
    for i in range(2):
        for tag in tags:
            got = _load(outs["torch"][i], f"direction_{tag}.npz")
            want = _load(outs["jax"][i], f"direction_{tag}.npz")
            assert got.shape == (1, 26, 512) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the serial sweep: each prompt from the resume file
    serial = str(root / "sweep_serial")
    out = _run(torch_cli, common + ["--outdir", serial, "--resume", r_file,
                                    "--device", "cpu"])
    assert "'an old face':" in out
    for tag in tags:
        np.testing.assert_allclose(
            _load(serial, f"direction_{tag}.npz"),
            _load(outs["torch"][0], f"direction_{tag}.npz"), rtol=0,
            atol=1e-4)
