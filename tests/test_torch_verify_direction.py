"""The verify harness's direction check (--torch_direction) in the port and
in the JAX package, on seeded files written as `test_torch_verify.py`
writes them (a file of its own: each package trains a direction at full
IR-SE-50 width, twice)."""

import os

import numpy as np
import pytest
import torch

from test_torch_verify import (REAL_TOL, RES, _compare_reports, _run,
                               write_files)
from stylemc_tpu.cli.verify_weights import main as jax_verify
from stylemc_torch.cli.verify_weights import main as torch_verify
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(str(tmp_path_factory.mktemp("verify_direction")),
                       ("clip", "arcface"))


START_SCALE = 1e-4   # a seeded start direction's entries: ~1e-4 of s


def _start(seed):
    """A seeded start direction at START_SCALE on the trainable rows."""
    from stylemc_torch.train.find_direction import TRAINABLE

    d = np.zeros((1, 26, 512), np.float32)
    rng = np.random.RandomState(seed)
    for row in TRAINABLE:
        d[:, row] = rng.randn(512).astype(np.float32) * START_SCALE
    return d


def _cosine(a, b):
    """verify's cosine_mean: the mean over the rows both directions hold."""
    a, b = (np.asarray(v, np.float64).reshape(26, 512) for v in (a, b))
    return float(np.mean([a[i] @ b[i] / (np.linalg.norm(a[i])
                                         * np.linalg.norm(b[i]))
                          for i in range(26) if np.linalg.norm(a[i]) > 1e-8
                          and np.linalg.norm(b[i]) > 1e-8]))


def test_direction_check_matches_jax(files):
    """--torch_direction across the packages: each CLI is given the
    direction the other package's find_direction recorded on the same
    files and seeds, and both report the same cosine (the one between the
    two recordings), the same `ok` and the same exit code; the port's CLI
    given its own recording reads cosine 1, a flipped one fails (exit 1).

    The run starts at Δs = 0, where the edited render equals the original
    and the CLIP term's feature difference vanishes, so the first Adam
    step (the sign of each gradient entry) is set by how Δs leaves zero:
    in the port the two renders are bitwise equal, in JAX they come from
    two XLA programs and differ by fp32 noise. The control: the port
    started from two seeded directions of entries ~1e-4 ends at cosine
    ~0.33 between them, so a direction trained from Δs = 0 is fixed only to
    within that spread, and the two packages' (~0.71) must sit within it.
    From the same seeded start the packages agree at cosine >= 0.999, ten
    times inside verify's own 0.99."""
    import importlib

    from stylemc_tpu.io import load_generator as jax_load_generator
    from stylemc_tpu.models.clip.load import load_clip as jax_load_clip
    from stylemc_tpu.models.clip.tokenizer import SimpleTokenizer
    from stylemc_tpu.utils.model_zoo import load_arcface as jax_load_arcface
    from stylemc_torch.io import load_generator
    from stylemc_torch.models.stylegan2.generator import mapping, w_to_s
    from stylemc_torch.train.find_direction import (FindDirectionConfig,
                                                    find_direction)
    from stylemc_torch.utils.model_zoo import load_arcface, load_clip_models

    jfd = importlib.import_module("stylemc_tpu.train.find_direction")
    cfg, params = load_generator(files["network"], device="cpu")
    zs = np.concatenate([np.random.RandomState(s).randn(1, cfg.z_dim)
                         for s in range(4)]).astype(np.float32)
    with torch.no_grad():
        styles = w_to_s(params, cfg, mapping(params, cfg,
                                             torch.from_numpy(zs),
                                             truncation_psi=0.7)).numpy()
    bpe = files["env"]["STYLEMC_CLIP_BPE"]
    os.environ["STYLEMC_CLIP_BPE"] = bpe
    try:
        clips, tok = load_clip_models("double", clip_dir=files["clip_dir"],
                                      device="cpu")
    finally:
        os.environ.pop("STYLEMC_CLIP_BPE")
    arc = load_arcface(files["arcface"], device="cpu")

    def port(start=None):
        return find_direction(params, cfg, styles, clips, arc,
                              FindDirectionConfig(resolution=RES),
                              tokenizer=tok,
                              resume_direction=start)[0].numpy()

    jcfg, jparams = jax_load_generator(files["network"])
    jclips = {name: jax_load_clip(name, files["clip_dir"])
              for name in ("ViT-B/32", "ViT-B/16")}
    jarc = jax_load_arcface(files["arcface"])

    def jax(start=None):
        return np.asarray(jfd.find_direction(
            jparams, jcfg, styles, jclips, jarc,
            jfd.FindDirectionConfig(resolution=RES),
            tokenizer=SimpleTokenizer(bpe), resume_direction=start)[0])

    recorded = {"torch": port(), "jax": jax()}
    started = port(_start(1))
    control = _cosine(started, port(_start(2)))
    between = _cosine(recorded["torch"], recorded["jax"])
    same_start = _cosine(started, jax(_start(1)))
    print(f"direction cosines: port against JAX from 0 {between:.6g}, "
          f"from one seeded start {same_start:.6g}; the port from two "
          f"seeded starts {control:.6g}")
    assert control < 0.99        # the control fails verify's threshold
    assert between >= control
    assert same_start >= 0.999

    def rec(name, d):
        path = os.path.join(files["dir"], f"direction_{name}.npz")
        np.savez(path, s=d)
        return path

    def verify(cli, name, path, device=True):
        return _run(cli, files, f"{name}.json",
                    ["--network", files["network"],
                     "--clip_dir", files["clip_dir"],
                     "--arcface", files["arcface"], "--seeds", "0-3",
                     "--torch_direction", path], device=device)

    # each CLI against the other package's recording
    tr, trep = verify(torch_verify, "torch_on_jax", rec("jax",
                                                        recorded["jax"]))
    jr, jrep = verify(jax_verify, "jax_on_torch", rec("torch",
                                                      recorded["torch"]),
                      device=False)
    assert tr.exit_code == jr.exit_code == (0 if between >= 0.99 else 1)
    _compare_reports(trep, jrep)
    for rep in (trep, jrep):
        det = rep["checks"]["direction_vs_torch"]["details"]
        assert det["threshold"] == 0.99
        print(f"reported cosine {det['cosine_mean']}")
        assert abs(det["cosine_mean"] - between) <= REAL_TOL["cosine_mean"][0]
    # the port's CLI against its own recording, and a flipped one
    res, rep = verify(torch_verify, "torch_dir", rec("torch",
                                                     recorded["torch"]))
    assert res.exit_code == 0, res.output
    assert rep["checks"]["direction_vs_torch"]["details"][
        "cosine_mean"] >= 0.999
    res, rep = verify(torch_verify, "torch_dir_bad",
                      rec("flipped", -recorded["torch"]))
    assert res.exit_code == 1
    assert not rep["all_ok"]
    assert not rep["checks"]["direction_vs_torch"]["ok"]
