"""The port's e4e training data pipeline and CLIs against the JAX
package's, on the CPU.

* infinite_sampler and batch_iterator (with the training flip): the same
  indices and batches; load_registry with a JSON overlay: the same specs;
  prefetch_iterator keeps every batch;
* train_e4e on 6 tiny PNGs for 2 steps from a fabricated tiny .pkl, both
  CLIs given the same tiny encoder, tiny ArcFace (patched into their
  loaders) and LPIPS-alex weights (a numpy pickle via STYLEMC_LPIPS_ALEX):
  every step's losses rtol 1e-4, the same printed keys, the same checkpoint
  files, last.pkl's encoder each leaf relative L2 1e-4 (a head that
  starts at zero has moved ~1e-10 after 2 steps); the port's checkpoint holds numpy
  arrays and plain values only, and a JAX-written one is refused;
* calc_losses_on_images in both modes: the printed JSON, rtol 1e-5 (the
  standard deviation, a spread of near values, within 1e-5 of the mean).
"""

import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.cli import calc_losses_on_images as jloss_cli
from stylemc_tpu.cli import train_e4e as jtrain_cli
from stylemc_tpu.data import configs as jconfigs
from stylemc_tpu.data import images as jimages
from stylemc_tpu.models.e4e import encoders as jenc
from stylemc_tpu.models.e4e import psp as jpsp
from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_tpu.train import coach as jcoach
from stylemc_tpu.utils import model_zoo as jzoo
from stylemc_torch.cli import calc_losses_on_images as tloss_cli
from stylemc_torch.cli import train_e4e as ttrain_cli
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.data import configs as tconfigs
from stylemc_torch.data import images as timages
from stylemc_torch.io.numpy_pickle import load_numpy_pickle
from stylemc_torch.losses import lpips as tlpips
from stylemc_torch.models.e4e import encoders as tenc
from stylemc_torch.models.e4e import psp as tpsp
from stylemc_torch.models.stylegan2 import generator as tgen
from stylemc_torch.train import coach as tcoach
from stylemc_torch.utils import model_zoo as tzoo
from test_pickle_loader import fabricate_pkl
from tiny import TINY_ARCFACE_LAYOUT, TINY_E4E_LAYOUT, tiny_arcface
from torch_threads import one_torch_thread  # noqa: F401

GEN_KW = dict(img_resolution=256, channel_base=512, channel_max=32,
              mapping_layers=2, conv_clamp=None)


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False),
                                dict(num_replicas=2, rank=1, seed=5)],
                         ids=["shuffle", "ordered", "replica"])
def test_infinite_sampler_matches_jax(kw):
    a = jimages.infinite_sampler(11, **kw)
    b = timages.infinite_sampler(11, **kw)
    assert [next(b) for _ in range(60)] == [next(a) for _ in range(60)]


class _Pairs:
    def __init__(self, n):
        rs = np.random.RandomState(0)
        self.items = [(rs.randn(3, 4, 5).astype(np.float32),
                       rs.randn(3, 4, 5).astype(np.float32))
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        x, y = self.items[i]
        return x.copy(), y.copy()


@pytest.mark.parametrize("kw", [dict(shuffle=True, flip=True, seed=3),
                                dict(shuffle=False)], ids=["flip", "plain"])
def test_batch_iterator_matches_jax(kw):
    ds = _Pairs(7)
    a = jimages.batch_iterator(ds, 3, **kw)
    b = timages.batch_iterator(ds, 3, **kw)
    for _ in range(6):
        (ax, ay), (bx, by) = a(), b()
        np.testing.assert_array_equal(bx, ax)
        np.testing.assert_array_equal(by, ay)


def test_prefetch_iterator_keeps_every_batch():
    import itertools

    counter = itertools.count()
    get = timages.prefetch_iterator(lambda: next(counter), depth=2)
    assert [get() for _ in range(5)] == [0, 1, 2, 3, 4]


def test_load_registry_matches_jax(tmp_path):
    import dataclasses

    path = tmp_path / "datasets.json"
    path.write_text(json.dumps({
        "ffhq_encode": {"train_source_root": "/data/ffhq",
                        "transforms": {"train_flip": False}},
        "new_encode": {"test_source_root": "/data/t",
                       "transforms": {"size": 128}}}))
    for p in (str(path), None):
        want = {k: dataclasses.asdict(v)
                for k, v in jconfigs.load_registry(p).items()}
        got = {k: dataclasses.asdict(v)
               for k, v in tconfigs.load_registry(p).items()}
        assert got == want
    assert tconfigs.model_paths.keys() == jconfigs.model_paths.keys()


# ------------------------------------------------------------------- CLIs


def _photos(root, n, seed):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        low = Image.fromarray((rs.rand(8, 8, 3) * 255).astype(np.uint8))
        low.resize((64, 64), Image.BICUBIC).save(
            os.path.join(root, f"img{i}.png"))
    return str(root)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny generator .pkl, tiny encoder and ArcFace weights, an LPIPS
    pickle and two folders of photos."""
    root = tmp_path_factory.mktemp("e4e_cli")
    gen = params_to_numpy(tgen.init_generator_params(
        torch.Generator().manual_seed(0), tgen.GeneratorConfig(**GEN_KW),
        device="cpu"))
    gen["mapping"]["w_avg"] = (np.random.RandomState(1).randn(512) * 0.1
                               ).astype(np.float32)
    pkl = fabricate_pkl(root, jgen.GeneratorConfig(**GEN_KW), gen)
    enc = params_to_numpy(tenc.init_encoder_params(
        torch.Generator().manual_seed(2), 256, layout=TINY_E4E_LAYOUT,
        device="cpu"))
    lpips = params_to_numpy(tlpips.init_lpips_params(
        torch.Generator().manual_seed(3), "alex", device="cpu"))
    lpips_file = str(root / "lpips_alex.pkl")
    with open(lpips_file, "wb") as f:
        pickle.dump(lpips, f)
    return {"pkl": pkl, "enc": enc, "lpips": lpips_file,
            "arcface": jax.tree_util.tree_map(np.asarray, tiny_arcface()),
            "photos": _photos(root / "photos", 6, 4),
            "other": _photos(root / "other", 6, 5), "root": root}


@pytest.fixture
def tiny_clis(files, monkeypatch):
    """Both CLIs with the tiny encoder (its layout in every PSPConfig) and
    the tiny ArcFace (its layout in every Coach), recording each step's
    losses at full precision."""
    enc, arc = files["enc"], files["arcface"]
    monkeypatch.setenv("STYLEMC_LPIPS_ALEX", files["lpips"])
    monkeypatch.setattr(jenc, "init_encoder_params", lambda *a, **kw:
                        jax.tree_util.tree_map(jnp.array, enc))
    monkeypatch.setattr(tenc, "init_encoder_params", lambda *a, device=None,
                        **kw: params_from_numpy(enc, device))
    monkeypatch.setattr(jzoo, "load_arcface", lambda *a, **kw: arc)
    monkeypatch.setattr(tzoo, "load_arcface", lambda *a, device=None, **kw:
                        params_from_numpy(arc, device))
    seen = {"jax": [], "torch": []}
    for name, psp_mod, coach_mod in (("jax", jpsp, jcoach),
                                     ("torch", tpsp, tcoach)):
        monkeypatch.setattr(psp_mod, "PSPConfig", functools.partial(
            psp_mod.PSPConfig, encoder_layout=TINY_E4E_LAYOUT))

        class Recording(coach_mod.Coach):
            def __init__(self, *a, _seen=seen[name], **kw):
                super().__init__(*a, arcface_layout=TINY_ARCFACE_LAYOUT, **kw)
                self._seen = _seen

            def train_step(self, *a, **kw):
                out = super().train_step(*a, **kw)
                self._seen.append(dict(out))
                return out

        monkeypatch.setattr(coach_mod, "Coach", Recording)
    return seen


def _printed(output):
    """{step: [(key, value), ...]} of the CLI's 'step N: k=v, ...' lines."""
    out = {}
    for line in output.splitlines():
        if line.startswith("step "):
            head, rest = line.split(": ", 1)
            out[int(head.split()[1])] = [
                (kv.split("=")[0], float(kv.split("=")[1]))
                for kv in rest.split(", ")]
    return out


def test_train_e4e_matches_jax_cli(files, tiny_clis, tmp_path):
    args = ["--source_root", files["photos"], "--stylegan_weights",
            files["pkl"], "--stylegan_size", "256", "--batch_size", "2",
            "--max_steps", "2", "--board_interval", "1"]
    jr = CliRunner().invoke(jtrain_cli.main, ["--exp_dir", str(
        tmp_path / "jax")] + args, catch_exceptions=False)
    assert jr.exit_code == 0, jr.output
    tr = CliRunner().invoke(ttrain_cli.main, ["--exp_dir", str(
        tmp_path / "torch"), "--device", "cpu"] + args,
        catch_exceptions=False)
    assert tr.exit_code == 0, tr.output
    assert tr.output.strip().splitlines()[-1] == "OMG, finished training!"

    # every step's losses, and the lines printed from them
    assert len(tiny_clis["torch"]) == len(tiny_clis["jax"]) == 2
    for a, b in zip(tiny_clis["jax"], tiny_clis["torch"]):
        assert list(b) == list(a)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=k)
    jp, tp = _printed(jr.output), _printed(tr.output)
    assert sorted(tp) == sorted(jp) == [1, 2]
    for step, rows in tp.items():
        assert [k for k, _ in rows] == [k for k, _ in jp[step]]
        assert rows == [(k, float(f"{v:.4f}")) for k, v in
                        tiny_clis["torch"][step - 1].items()]

    # the same checkpoint files; last.pkl's encoder
    jdir, tdir = (tmp_path / n / "checkpoints" for n in ("jax", "torch"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == \
        ["iteration_2.pkl", "last.pkl"]
    with open(jdir / "last.pkl", "rb") as f:
        want = pickle.load(f)
    got = load_numpy_pickle(str(tdir / "last.pkl"))
    assert got["global_step"] == want["global_step"] == 2
    assert {k: v for k, v in got["opts"].items() if k != "exp_dir"} == \
        {k: v for k, v in want["opts"].items() if k != "exp_dir"}
    flat_w = jax.tree_util.tree_leaves_with_path(want["encoder_params"])
    for path, v in flat_w:
        node = got["encoder_params"]
        for key in path:
            node = node[key.key]
        v = np.asarray(v)
        assert np.linalg.norm(node - v) <= 1e-4 * np.linalg.norm(v), path
    # a JAX-written checkpoint holds optax objects: the port refuses it
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        load_numpy_pickle(str(jdir / "last.pkl"))


@pytest.mark.parametrize("mode", ["lpips", "l2"])
def test_calc_losses_on_images_matches_jax_cli(files, monkeypatch, mode):
    """The images of one folder against the other's, matched by name, at
    batch 4: lpips gives a value per batch (n = 2), l2 one per image."""
    monkeypatch.setenv("STYLEMC_LPIPS_ALEX", files["lpips"])
    args = ["--mode", mode, "--data_path", files["other"], "--gt_path",
            files["photos"], "--batch", "4"]
    jr = CliRunner().invoke(jloss_cli.main, args, catch_exceptions=False)
    tr = CliRunner().invoke(tloss_cli.main, args + ["--device", "cpu"],
                            catch_exceptions=False)
    assert jr.exit_code == tr.exit_code == 0, jr.output + tr.output
    want = json.loads(jr.output.strip().splitlines()[-1])
    got = json.loads(tr.output.strip().splitlines()[-1])
    assert tr.output.splitlines()[0] == jr.output.splitlines()[0] == \
        "6 matched pairs"
    assert got["mode"] == want["mode"] == mode
    assert got["n"] == want["n"] == (2 if mode == "lpips" else 6)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5)
    # the spread of near values: held to 1e-5 of their scale, the mean
    np.testing.assert_allclose(got["std"], want["std"], rtol=0,
                               atol=1e-5 * want["mean"])
