"""The port's CLIs and checkpoint loaders against the JAX package's, on the
CPU, over a fabricated NVIDIA-format pickle.

generate_w → w_s_converter → generate_fromS run through both packages: the
npz files agree within 1e-5 and the [orig | edited] JPEGs within ±1 per
pixel. The port's unpickler never runs a pickle's embedded source.
"""

import os
import pickle

import jax
import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.io import load_generator as jax_load_generator
from stylemc_tpu.io.native import load_native as jax_load_native
from stylemc_tpu.io.native import save_native as jax_save_native
from stylemc_tpu.models.stylegan2.generator import (
    GeneratorConfig as JaxConfig, init_generator_params)
from stylemc_torch.convert import params_to_numpy
from stylemc_torch.io import (PersistentStub, load_generator,
                              load_network_pkl, load_native, save_native)
from test_pickle_loader import fabricate_pkl
from torch_threads import one_torch_thread  # noqa: F401

CFG_KW = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2)
PROMPT = "test prompt"


@pytest.fixture(scope="module")
def pkl_path(tmp_path_factory):
    cfg = JaxConfig(**CFG_KW)
    params = init_generator_params(jax.random.PRNGKey(0), cfg)
    return fabricate_pkl(tmp_path_factory.mktemp("net"), cfg, params)


def _invoke(main, args):
    r = CliRunner().invoke(main, args, catch_exceptions=False)
    assert r.exit_code == 0, r.output


def _pipeline(pkg, pkl, root, extra):
    """generate_w → w_s_converter → generate_fromS through one package."""
    import importlib

    cli = {name: importlib.import_module(f"{pkg}.cli.{name}").main
           for name in ("generate_w", "w_s_converter", "generate_fromS")}
    w_file, s_file = os.path.join(root, "w.npz"), os.path.join(root, "s.npz")
    outdir = os.path.join(root, "out")
    os.makedirs(outdir, exist_ok=True)
    d = np.zeros((1, 26, 512), np.float32)
    d[:, 2, :64] = 0.2
    np.savez(os.path.join(outdir, f"direction_{PROMPT.replace(' ', '_')}.npz"),
             s=d)
    _invoke(cli["generate_w"], ["--network", pkl, "--seeds", "1-4", "--trunc",
                                "0.7", "--out_file", w_file] + extra)
    _invoke(cli["w_s_converter"], ["--network", pkl, "--projected-w", w_file,
                                   "--out_file", s_file] + extra)
    _invoke(cli["generate_fromS"], ["--network", pkl, "--s_input", s_file,
                                    "--outdir", outdir, "--text_prompt",
                                    PROMPT, "--change_power", "2.0"] + extra)
    jpegs = sorted(f for f in os.listdir(outdir) if f.endswith(".jpeg"))
    return (np.load(w_file)["w"], np.load(s_file)["s"],
            [np.asarray(Image.open(os.path.join(outdir, f))) for f in jpegs],
            jpegs)


def test_cli_pipeline_matches_jax(pkl_path, tmp_path):
    jw, js, jimgs, jnames = _pipeline("stylemc_tpu", pkl_path,
                                      str(tmp_path / "jax"), [])
    tw, ts, timgs, tnames = _pipeline("stylemc_torch", pkl_path,
                                      str(tmp_path / "torch"),
                                      ["--device", "cpu"])
    assert tw.shape == (4, 8, 512) and ts.shape == (4, 26, 512)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    assert tnames == jnames == [f"test_prompt_{i:03d}.jpeg" for i in range(4)]
    for a, b in zip(timgs, jimgs):
        assert a.shape == (32, 64, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        assert np.abs(a[:, :32].astype(int) - a[:, 32:].astype(int)).max() > 0


def test_generate_fromS_projected_w_and_sweep(pkl_path, tmp_path):
    from stylemc_torch.cli.generate_fromS import main as generate_fromS
    from stylemc_torch.cli.generate_w import main as generate_w
    from stylemc_torch.cli.generate_w import num_range

    assert num_range("2-4") == [2, 3, 4] and num_range("5,1") == [5, 1]
    w_file = str(tmp_path / "w.npz")
    outdir = str(tmp_path / "out")
    _invoke(generate_w, ["--network", pkl_path, "--seeds", "1,2",
                         "--out_file", w_file, "--device", "cpu"])
    _invoke(generate_fromS, ["--network", pkl_path, "--projected-w", w_file,
                             "--outdir", outdir, "--text_prompt", "x",
                             "--device", "cpu"])
    assert sorted(os.listdir(outdir)) == ["proj00.png", "proj01.png"]
    s_file = str(tmp_path / "s.npz")
    np.savez(s_file, s=np.zeros((1, 26, 512), np.float32))
    np.savez(os.path.join(outdir, "direction_x.npz"),
             s=np.ones((1, 26, 512), np.float32) * 0.1)
    _invoke(generate_fromS, ["--network", pkl_path, "--s_input", s_file,
                             "--outdir", outdir, "--text_prompt", "x",
                             "--power_sweep", "0:2:3", "--device", "cpu"])
    gif = Image.open(os.path.join(outdir, "x_000_sweep.gif"))
    assert gif.n_frames == 3


def test_cli_refuses_cpu_fallback(pkl_path, tmp_path, monkeypatch):
    import torch

    from stylemc_torch.cli.generate_w import main as generate_w

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = CliRunner().invoke(generate_w, ["--network", pkl_path, "--seeds", "1",
                                        "--out_file", str(tmp_path / "w.npz")])
    assert r.exit_code != 0 and isinstance(r.exception, RuntimeError)
    assert not os.path.exists(tmp_path / "w.npz")


def test_legacy_cli_and_native_interchange(pkl_path, tmp_path):
    from stylemc_torch.cli.legacy import main as legacy

    dest = str(tmp_path / "net.npz")
    _invoke(legacy, ["--source", pkl_path, "--dest", dest])
    jcfg, jparams = jax_load_native(dest)           # the JAX package reads it
    jcfg0, jparams0 = jax_load_generator(pkl_path)
    assert jcfg == jcfg0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams0):
        node = jparams
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
    # and the port reads what the JAX package writes
    jdest = str(tmp_path / "jax.npz")
    jax_save_native(jdest, jcfg0, jparams0)
    tcfg, tparams = load_native(jdest, device="cpu")
    assert tcfg.img_resolution == 32 and tcfg.num_ws == jcfg0.num_ws
    tdest = str(tmp_path / "torch.npz")
    save_native(tdest, tcfg, tparams)
    a, b = np.load(jdest), np.load(tdest)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # --dest .pt writes the rosinality checkpoint the JAX package writes
    import torch
    from stylemc_tpu.io.export import save_rosinality_pt
    _invoke(legacy, ["--source", pkl_path, "--dest", str(tmp_path / "x.pt")])
    save_rosinality_pt(str(tmp_path / "jax.pt"), jcfg0, jparams0)
    a, b = (torch.load(str(tmp_path / f), weights_only=True)
            for f in ("x.pt", "jax.pt"))
    assert sorted(a["g_ema"]) == sorted(b["g_ema"])
    for k, v in b["g_ema"].items():
        assert torch.equal(a["g_ema"][k], v), k
    assert torch.equal(a["latent_avg"], b["latent_avg"])
    r = CliRunner().invoke(legacy, ["--source", pkl_path, "--dest",
                                    str(tmp_path / "x.bin")])
    assert r.exit_code != 0


def test_pkl_params_match_jax_loader(pkl_path):
    jcfg, jparams = jax_load_generator(pkl_path)
    tcfg, tparams = load_generator(pkl_path, device="cpu")
    import dataclasses
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tnp = params_to_numpy(tparams)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == len(jax.tree_util.tree_leaves(tnp))
    for path, leaf in leaves:
        node = tnp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_embedded_source_never_executed(pkl_path):
    # the fabricated module_src raises if exec'd; loading must succeed
    data = load_network_pkl(pkl_path)
    assert isinstance(data["G_ema"], PersistentStub)
    assert data["G_ema"].class_name == "Generator"
    assert "raise RuntimeError" in data["G_ema"].meta["module_src"]


def test_malicious_reduce_and_gadgets_neutralized(tmp_path):
    canary = str(tmp_path / "pwned")

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {canary}",))

    class Gadget:
        def __reduce__(self):
            import numpy.testing
            return (numpy.testing.runstring,
                    (f"import os; os.system('touch {canary}')", {}))

    for i, payload in enumerate(({"G_ema": Evil()}, {"G_ema": [Gadget()]})):
        path = str(tmp_path / f"evil{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        load_network_pkl(path)  # must not execute anything
        assert not os.path.exists(canary)
    with open(str(tmp_path / "tf.pkl"), "wb") as f:
        pickle.dump((1, 2, 3), f)
    with pytest.raises(ValueError):
        load_network_pkl(str(tmp_path / "tf.pkl"))
