"""The port's utilities and small CLIs against the JAX package's, on the
CPU: `utils/{dnnlib,misc,profiling}` (mirroring `tests/test_utils.py`),
`io.torch_state.state_from_params`, `clip_filter`, `compare_directions` and
the `python -m stylemc_torch` dispatcher."""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_tpu.utils import profiling as jprof
from stylemc_torch.convert import params_from_numpy
from stylemc_torch.utils.dnnlib import (EasyDict, Logger, call_func_by_name,
                                        construct_class_by_name,
                                        get_obj_by_name, is_url, open_url)
from stylemc_torch.utils.misc import assert_shape, num_range, unravel_index
from stylemc_torch.utils.profiling import (count_params, print_params_summary,
                                           profiled_function, record_function,
                                           trace)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_easydict():
    d = EasyDict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2
    del d.a
    with pytest.raises(AttributeError):
        _ = d.a


def test_logger_tee(tmp_path):
    path = str(tmp_path / "log.txt")
    stdout = sys.stdout
    with Logger(path):
        print("hello-tee")
        assert sys.stdout is not stdout
    assert sys.stdout is stdout
    assert "hello-tee" in open(path).read()


def test_is_url_and_local_open_url(tmp_path):
    assert is_url("https://example.com/x.pkl")
    assert not is_url("/tmp/foo.pkl")
    assert not is_url("file:///tmp/foo.pkl")
    assert is_url("file:///tmp/foo.pkl", allow_file_urls=True)
    p = tmp_path / "f.bin"
    p.write_bytes(b"data")
    with open_url(str(p)) as f:
        assert f.read() == b"data"
    with open_url(p.as_uri()) as f:
        assert f.read() == b"data"


def test_construct_class_by_name():
    od = construct_class_by_name([("a", 1)],
                                 class_name="collections.OrderedDict")
    assert od["a"] == 1
    assert get_obj_by_name("numpy.sum") is np.sum
    assert call_func_by_name([1, 2], func_name="builtins.sum") == 3
    with pytest.raises(ImportError):
        get_obj_by_name("no_such_module_here.attr")


def test_profiled_function_and_record_function_in_a_trace(tmp_path):
    @profiled_function
    def doubled(x):
        return x * 2

    with trace(str(tmp_path), "t.json", device="cpu") as prof:
        assert float(doubled(torch.tensor(3.0))) == 6.0
        with record_function("named_scope"):
            torch.ones(2).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"doubled", "named_scope"} <= names
    with open(tmp_path / "t.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "named_scope" for e in events)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_params_summary_matches_jax(depth):
    cfg = jgen.GeneratorConfig(img_resolution=8, channel_base=256,
                               channel_max=16, mapping_layers=1)
    tree = jax.device_get(jgen.init_generator_params(jax.random.PRNGKey(0),
                                                     cfg))
    want, got = io.StringIO(), io.StringIO()
    total = jprof.print_params_summary(tree, max_depth=depth, file=want)
    assert print_params_summary(params_from_numpy(tree, "cpu"),
                                max_depth=depth, file=got) == total
    assert got.getvalue() == want.getvalue()
    assert "TOTAL" in got.getvalue()
    assert count_params(tree) == jprof.count_params(tree) == total


def test_params_summary_of_a_module():
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                              torch.nn.Linear(3, 2))
    out = io.StringIO()
    assert print_params_summary(net, name="net", file=out) == 4 * 3 + 3 + \
        3 * 2 + 2
    assert "net.0" in out.getvalue() and "net.2" in out.getvalue()


def test_misc_helpers():
    from stylemc_tpu.utils import misc as jmisc

    for spec in ("3-6", "1,5,9", "7"):
        assert num_range(spec) == jmisc.num_range(spec)
    assert_shape(np.zeros((2, 3)), [None, 3])
    with pytest.raises(AssertionError):
        assert_shape(torch.zeros(2, 3), [None, 4])
    with pytest.raises(AssertionError):
        assert_shape(np.zeros((2, 3)), [2])
    for i in range(24):
        assert unravel_index(i, (2, 3, 4)) == jmisc.unravel_index(i, (2, 3, 4))
        assert unravel_index(i, (2, 3, 4)) == np.unravel_index(i, (2, 3, 4))


@pytest.mark.parametrize("model", ["arcface", "inception", "clip_vit",
                                   "clip_rn"])
def test_state_from_params_inverts_the_state_converters(model):
    from stylemc_torch.io.torch_state import state_from_params
    from stylemc_torch.metrics import inception
    from stylemc_torch.models import arcface
    from stylemc_torch.models.clip import model as clip

    gen = torch.Generator().manual_seed(0)
    if model == "arcface":
        conv, params, args = arcface.params_from_torch_state, \
            arcface.init_backbone_params(gen, device="cpu"), ()
    elif model == "inception":
        conv, params, args = inception.params_from_torch_state, \
            inception.init_inception_params(gen, device="cpu"), ()
    else:
        cfg = clip.CLIPConfig(
            embed_dim=16, image_resolution=64 if model == "clip_rn" else 32,
            vision_layers=(1, 1, 1, 1) if model == "clip_rn" else 1,
            vision_width=32 if model == "clip_rn" else 64,
            vision_patch_size=None if model == "clip_rn" else 16,
            transformer_width=32, transformer_heads=2, transformer_layers=1)
        conv, params, args = clip.params_from_torch_state, \
            clip.init_clip_params(gen, cfg, device="cpu"), (cfg,)
    state = state_from_params(conv, params, *args)
    assert all(v.dtype == np.float32 for v in state.values())
    back = params_from_numpy(conv(state, *args), "cpu")

    def leaves(t, p=""):
        return ({k: v for kk, vv in t.items() for k, v in
                 leaves(vv, f"{p}/{kk}").items()} if isinstance(t, dict)
                else {p: t})

    a, b = leaves(back), leaves(params)
    assert sorted(a) == sorted(b)
    for k in b:  # params_from_numpy keeps a scalar as shape [1]
        torch.testing.assert_close(a[k].reshape(b[k].shape), b[k].float(),
                                   rtol=0, atol=0)
    assert len(state) == len(b)


# ------------------------------------------------------------- small CLIs


@pytest.fixture(scope="module")
def clip_filter_data(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("clip_filter")
    img_dir = d / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(img_dir / f"im_{i:03d}.png")
    styles = rng.randn(8, 26, 512).astype(np.float32)
    np.savez(d / "s.npz", s=styles)
    return d, img_dir, styles


@pytest.mark.parametrize("keep_class", [0, 1])
def test_clip_filter_matches_jax(clip_filter_data, monkeypatch, keep_class):
    """The same tiny CLIP in both packages: the kept indices, paths and
    styles equal, and the two classes partition the images."""
    from stylemc_tpu.cli.clip_filter import main as jax_clip_filter
    from stylemc_tpu.models.clip.model import CLIPConfig, init_clip_params
    from stylemc_tpu.models.clip.tokenizer import (
        FallbackTokenizer as JaxTokenizer)
    from stylemc_tpu.utils import model_zoo as jzoo
    from stylemc_torch.cli.clip_filter import main as torch_clip_filter
    from stylemc_torch.models.clip import FallbackTokenizer
    from stylemc_torch.utils import model_zoo as tzoo

    tiny = CLIPConfig(embed_dim=16, image_resolution=32, vision_layers=1,
                      vision_width=64, vision_patch_size=16,
                      transformer_width=32, transformer_heads=2,
                      transformer_layers=1)
    jp = jax.device_get(init_clip_params(jax.random.PRNGKey(0), tiny))
    monkeypatch.setattr(jzoo, "load_clip_models",
                        lambda kind, allow_random_init=False: (
                            {"ViT-B/32": (tiny, jp)}, JaxTokenizer()))
    monkeypatch.setattr(tzoo, "load_clip_models",
                        lambda kind, allow_random_init=False, device=None: (
                            {"ViT-B/32": (tiny, params_from_numpy(jp, device))},
                            FallbackTokenizer()))
    d, img_dir, styles = clip_filter_data
    outs = {}
    for name, cli, extra in (("jax", jax_clip_filter, []),
                             ("torch", torch_clip_filter,
                              ["--device", "cpu"])):
        outs[name] = d / f"{name}_{keep_class}.npz"
        res = CliRunner().invoke(cli, [
            "--images_dir", str(img_dir), "--s_input", str(d / "s.npz"),
            "--prompts", "a photo of a man|a photo of a woman",
            "--keep_class", str(keep_class), "--out_file",
            str(outs[name]), "--batch", "8"] + extra)
        assert res.exit_code == 0, res.output
    got, want = np.load(outs["torch"]), np.load(outs["jax"])
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["paths"], want["paths"])
    np.testing.assert_array_equal(got["s"], styles[want["indices"]])
    other = np.load(d / f"jax_{1 - keep_class}.npz") \
        if (d / f"jax_{1 - keep_class}.npz").exists() else None
    if other is not None:
        assert sorted(list(got["indices"]) + list(other["indices"])) == \
            list(range(8))


def _direction_files(tmp_path):
    rs = np.random.RandomState(0)
    a = rs.randn(1, 26, 512).astype(np.float32)
    a[:, 3] = 0          # a channel empty in both
    b = a + rs.randn(1, 26, 512).astype(np.float32) * 0.05
    b[:, 3] = 0
    b[:, 5] = 0          # a channel empty in one
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    np.savez(pa, s=a)
    np.savez(pb, s=b)
    return pa, pb


@pytest.mark.parametrize("threshold", ["0.99", "-1.0"])
def test_compare_directions_matches_jax(tmp_path, threshold):
    from stylemc_tpu.cli.compare_directions import main as jax_compare
    from stylemc_torch.cli.compare_directions import main as torch_compare

    pa, pb = _direction_files(tmp_path)
    args = [pa, pb, "--threshold", threshold]
    got = CliRunner().invoke(torch_compare, args)
    want = CliRunner().invoke(jax_compare, args)
    assert got.exit_code == want.exit_code == 0
    assert got.output == want.output
    result = json.loads(got.output)
    assert result["per_channel_cosine"][3] == 1.0
    assert result["per_channel_cosine"][5] == 0.0
    assert result["pass"] == (threshold == "-1.0")


def test_main_lists_and_dispatches_like_jax(tmp_path):
    import importlib

    jmain = importlib.import_module("stylemc_tpu.__main__")
    tmain = importlib.import_module("stylemc_torch.__main__")
    assert tmain.CLIS == jmain.CLIS
    assert tmain._ALIASES == jmain._ALIASES
    for name, _ in tmain.CLIS:
        mod = importlib.import_module(
            f"stylemc_torch.cli.{tmain._ALIASES.get(name, name)}")
        assert callable(mod.main), name
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    listing = subprocess.run([sys.executable, "-m", "stylemc_torch"],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
    assert listing.returncode == 0, listing.stderr
    for name, desc in tmain.CLIS:
        assert name in listing.stdout and desc in listing.stdout
    pa, pb = _direction_files(tmp_path)
    run = subprocess.run([sys.executable, "-m", "stylemc_torch",
                          "compare_directions", pa, pb], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    from stylemc_tpu.cli.compare_directions import main as jax_compare
    assert run.stdout == CliRunner().invoke(jax_compare, [pa, pb]).output


def test_new_entry_points_raise_without_cuda(tmp_path, monkeypatch,
                                             clip_filter_data):
    from stylemc_torch.cli.clip_filter import main as clip_filter
    from stylemc_torch.cli.verify_weights import main as verify
    from stylemc_torch.io import discriminator_from_stub
    from stylemc_torch.io.pickle_loader import PersistentStub
    from stylemc_torch.models.stylegan2.discriminator import (
        init_discriminator_params)

    d, img_dir, _ = clip_filter_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_discriminator_params(torch.Generator(), size=16)
    stub = PersistentStub({"class_name": "Discriminator",
                           "state": {"init_args": (),
                                     "init_kwargs": {"size": 16}}})
    stub.named_tensors = lambda: {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        discriminator_from_stub(stub)
    for cli, args in ((clip_filter, ["--images_dir", str(img_dir),
                                     "--prompts", "a|b", "--keep_class", "0",
                                     "--out_file", str(tmp_path / "o.npz")]),
                      (verify, ["--report", str(tmp_path / "r.json")])):
        res = CliRunner().invoke(cli, args)
        assert res.exit_code != 0
        assert "no CUDA device" in str(res.exception)
