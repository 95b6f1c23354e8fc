"""Legacy TensorFlow pickles and the StyleGAN2 discriminator in the port
against the JAX package, on the CPU.

Both packages load the same (G, D, Gs) pickle, fabricated by the JAX side's
own `tests/test_tf_legacy.py` helpers from seeded JAX params: the converted
tensors and the generator's and discriminator's params must be exactly
equal, renders within the generator's 1e-4, discriminator logits and their
input gradient within 1e-5. The port's own JAX-free writer
(`stylemc_torch.bench.tf_pickle`) must write the same variables.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from stylemc_tpu.cli.legacy import main as jax_legacy
from stylemc_tpu.io import load_generator as jax_load_generator
from stylemc_tpu.io import load_network_pkl as jax_load_network_pkl
from stylemc_tpu.io.tf_legacy import collect_tf_params as jax_collect
from stylemc_tpu.io.tf_legacy import (
    discriminator_from_stub as jax_discriminator_from_stub)
from stylemc_tpu.models.stylegan2 import discriminator as jdisc
from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_torch.bench import tf_pickle
from stylemc_torch.cli.legacy import main as torch_legacy
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.io import (PersistentStub, TFNetworkStub,
                              discriminator_from_stub, load_generator,
                              load_native, load_network_pkl)
from stylemc_torch.io.tf_legacy import collect_tf_params
from stylemc_torch.models.stylegan2 import discriminator as tdisc
from stylemc_torch.models.stylegan2 import generator as tgen
from test_tf_legacy import (_install_fake_tflib, fabricate_tf_discriminator,
                            fabricate_tf_generator)
from torch_threads import one_torch_thread  # noqa: F401

TF_KW = dict(img_resolution=16, channel_base=512, channel_max=64,
             mapping_layers=2, conv_clamp=None, num_fp16_res=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(
                v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32),
                                      err_msg=k)


def _write(path, tf_G, tf_D, tf_Gs):
    with open(path, "wb") as f:
        pickle.dump((tf_G, tf_D, tf_Gs), f)
    return path


@pytest.fixture(scope="module")
def tf_pkl(tmp_path_factory):
    Network = _install_fake_tflib()
    cfg = jgen.GeneratorConfig(**TF_KW)
    g_params = jgen.init_generator_params(jax.random.PRNGKey(0), cfg)
    d_params = jdisc.init_discriminator_params(jax.random.PRNGKey(1),
                                               size=16)
    path = _write(os.path.join(str(tmp_path_factory.mktemp("tfpkl")),
                               "tf_net.pkl"),
                  fabricate_tf_generator(Network, cfg, g_params),
                  fabricate_tf_discriminator(Network, 16, d_params),
                  fabricate_tf_generator(Network, cfg, g_params))
    return cfg, g_params, d_params, path


def test_tf_pickle_converts_to_the_same_tensors(tf_pkl):
    *_, path = tf_pkl
    got, want = load_network_pkl(path), jax_load_network_pkl(path)
    assert set(got) == set(want) == {"G", "D", "G_ema",
                                     "training_set_kwargs", "augment_pipe"}
    assert got["training_set_kwargs"] is None and got["augment_pipe"] is None
    for key in ("G", "D", "G_ema"):
        assert isinstance(got[key], PersistentStub)
        assert got[key].class_name == want[key].class_name
        assert got[key].init_kwargs == want[key].init_kwargs
        a, b = got[key].named_tensors(), want[key].named_tensors()
        assert sorted(a) == sorted(b)
        for name in b:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
            assert a[name].dtype == np.asarray(b[name]).dtype, name


def test_tf_generator_params_exact_and_renders_match_jax(tf_pkl):
    cfg, g_params, _, path = tf_pkl
    tcfg, tparams = load_generator(path, device="cpu")
    jcfg, jparams = jax_load_generator(path)
    assert tcfg == tgen.GeneratorConfig(**TF_KW)
    assert jcfg == cfg
    _assert_trees_equal(tparams, jparams)
    _assert_trees_equal(tparams, g_params)
    z = np.random.RandomState(7).randn(2, cfg.z_dim).astype(np.float32)
    want = jgen.generate(jparams, jcfg, jnp.asarray(z), truncation_psi=0.7)
    with torch.no_grad():
        got = tgen.generate(tparams, tcfg, torch.from_numpy(z),
                            truncation_psi=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_tf_discriminator_params_logits_and_gradient_match_jax(tf_pkl):
    *_, d_params, path = tf_pkl
    size, tparams = discriminator_from_stub(load_network_pkl(path)["D"],
                                            device="cpu")
    jsize, jparams = jax_discriminator_from_stub(
        jax_load_network_pkl(path)["D"])
    assert size == jsize == 16
    _assert_trees_equal(tparams, jparams)
    _assert_trees_equal(tparams, d_params)
    x = (np.random.RandomState(3).randn(2, 3, 16, 16) * 0.5).astype(
        np.float32)
    jl, jvjp = jax.vjp(lambda xx: jdisc.discriminator_apply(jparams, xx),
                       jnp.asarray(x))
    jg, = jvjp(jnp.ones_like(jl))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = tdisc.discriminator_apply(tparams, tx)
    tl.sum().backward()
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * scale)
    gscale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * gscale)


def test_tf_embedded_source_never_executed(tf_pkl):
    # the fabricated build_module_src raises if it is ever executed
    *_, path = tf_pkl
    data = load_network_pkl(path)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert "raise RuntimeError" in raw[0].build_module_src
    assert isinstance(data["G"], PersistentStub)


def _tiny_tf_generator(Network=None):
    Network = Network or _install_fake_tflib()
    cfg = jgen.GeneratorConfig(**TF_KW)
    params = jgen.init_generator_params(jax.random.PRNGKey(0), cfg)
    return fabricate_tf_generator(Network, cfg, params)


def _mutate_unknown_kwarg(tf_G):
    tf_G.static_kwargs["totally_new_option"] = 3


def _mutate_version(tf_G):
    tf_G.version = 3


def _mutate_progressive(tf_G):
    tf_G.variables.append(("ToRGB_lod0/weight",
                           np.zeros((1, 1, 3, 3), np.float32)))


@pytest.mark.parametrize("mutate, error, match", [
    (_mutate_unknown_kwarg, ValueError, "Unknown TensorFlow kwarg"),
    (_mutate_version, ValueError, "version too low"),
    (_mutate_progressive, NotImplementedError, "progressive"),
], ids=["unknown_kwarg", "version", "progressive"])
def test_tf_rejections_match_jax(tmp_path, mutate, error, match):
    tf_G = _tiny_tf_generator()
    mutate(tf_G)
    path = _write(str(tmp_path / "bad.pkl"), tf_G, tf_G, tf_G)
    with pytest.raises(error, match=match) as got:
        load_network_pkl(path)
    with pytest.raises(error) as want:
        jax_load_network_pkl(path)
    assert str(got.value) == str(want.value)


def test_conditional_discriminator_rejected(tmp_path):
    Network = _install_fake_tflib()
    d_params = jdisc.init_discriminator_params(jax.random.PRNGKey(1),
                                               size=16)
    tf_D = fabricate_tf_discriminator(Network, 16, d_params)
    tf_D.static_kwargs["label_size"] = 10
    tf_G = _tiny_tf_generator(Network)
    path = _write(str(tmp_path / "cond.pkl"), tf_G, tf_D, tf_G)
    with pytest.raises(NotImplementedError,
                       match="conditional discriminator"):
        load_network_pkl(path)


def test_ada_discriminator_namespace_import():
    """An NVIDIA torch-pickle D stub carries the ADA names (b{res}.conv0 /
    conv1 / skip, b4.conv / fc / out): both packages rebuild the same
    params, the size inferred from the top stem."""
    from stylemc_tpu.io.pickle_loader import PersistentStub as JaxStub

    d_params = jdisc.init_discriminator_params(jax.random.PRNGKey(2),
                                               size=16)
    t = {"b16.fromrgb.weight": np.asarray(d_params["stem"]["weight"]),
         "b16.fromrgb.bias": np.asarray(d_params["stem"]["bias"])}
    for r in (16, 8):
        bp = d_params[f"block{r}"]
        t[f"b{r}.conv0.weight"] = np.asarray(bp["conv1"]["weight"])
        t[f"b{r}.conv0.bias"] = np.asarray(bp["conv1"]["bias"])
        t[f"b{r}.conv1.weight"] = np.asarray(bp["conv2"]["weight"])
        t[f"b{r}.conv1.bias"] = np.asarray(bp["conv2"]["bias"])
        t[f"b{r}.skip.weight"] = np.asarray(bp["skip_weight"])
    for ours, ada in (("final_conv", "conv"), ("final_linear1", "fc"),
                      ("final_linear2", "out")):
        t[f"b4.{ada}.weight"] = np.asarray(d_params[ours]["weight"])
        t[f"b4.{ada}.bias"] = np.asarray(d_params[ours]["bias"])
    meta = {"class_name": "Discriminator",
            "state": {"init_args": (), "init_kwargs": {}}}
    stub, jstub = PersistentStub(meta), JaxStub(meta)
    stub.named_tensors = jstub.named_tensors = lambda: t
    size, got = discriminator_from_stub(stub, device="cpu")
    jsize, want = jax_discriminator_from_stub(jstub)
    assert size == jsize == 16
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, d_params)


def test_legacy_cli_on_a_tf_pickle_matches_jax(tf_pkl, tmp_path):
    *_, path = tf_pkl
    outs = {}
    for name, cli in (("jax", jax_legacy), ("torch", torch_legacy)):
        outs[name] = str(tmp_path / f"{name}.npz")
        res = CliRunner().invoke(cli, ["--source", path,
                                       "--dest", outs[name]])
        assert res.exit_code == 0, res.output
    a, b = np.load(outs["torch"]), np.load(outs["jax"])
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfg, params = load_native(outs["torch"], device="cpu")
    _, want = jax_load_generator(path)
    _assert_trees_equal(params, want)


def test_port_writer_matches_the_jax_fabrication(tmp_path):
    """The port's JAX-free writer and the JAX side's fabrication write the
    same variables, kwargs and layout from the same params."""
    Network = _install_fake_tflib()
    cfg = jgen.GeneratorConfig(**TF_KW)
    g = jgen.init_generator_params(jax.random.PRNGKey(5), cfg)
    d = jdisc.init_discriminator_params(jax.random.PRNGKey(6), size=16)
    want = _write(str(tmp_path / "jax.pkl"),
                  fabricate_tf_generator(Network, cfg, g),
                  fabricate_tf_discriminator(Network, 16, d),
                  fabricate_tf_generator(Network, cfg, g))
    got = tf_pickle.write_tf_pickle(
        str(tmp_path / "port.pkl"), tgen.GeneratorConfig(**TF_KW),
        params_from_numpy(jax.device_get(g), "cpu"),
        params_from_numpy(jax.device_get(d), "cpu"), 16)
    with open(got, "rb") as f:
        a = pickle.load(f)
    with open(want, "rb") as f:
        b = pickle.load(f)
    for na, nb in zip(a, b):
        for attr in ("version", "name", "static_kwargs", "build_func_name"):
            assert getattr(na, attr) == getattr(nb, attr), attr
        pa, pb = collect_tf_params(na), jax_collect(nb)
        assert list(pa) == list(pb)
        for k in pb:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
            assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape
    _, params = load_generator(got, device="cpu")
    _assert_trees_equal(params, g)
    with open(got, "rb") as f:
        from stylemc_torch.io.pickle_loader import _SafeUnpickler
        raw = _SafeUnpickler(f).load()
    assert all(isinstance(n, TFNetworkStub) for n in raw)


# ------------------------------------------------------------ discriminator


@pytest.fixture(scope="module", params=[32, 64], ids=["d32", "d64"])
def dnets(request):
    size = request.param
    jp = jdisc.init_discriminator_params(jax.random.PRNGKey(size),
                                         size=size, channel_multiplier=1)
    # the biases are zero at init: make them take part
    rs = np.random.RandomState(size)
    jp = jax.tree_util.tree_map(
        lambda a: a + (rs.randn(*a.shape).astype(np.float32) * 0.1
                       if a.ndim == 1 else 0), jax.device_get(jp))
    return size, jp, params_from_numpy(jp, "cpu")


def test_d_channels_match_jax():
    for size in (16, 32, 64, 256, 1024):
        for mult in (1, 2):
            assert tdisc.d_channels(size, mult) == jdisc.d_channels(size,
                                                                    mult)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_minibatch_stddev_matches_jax(n):
    x = np.random.RandomState(n).randn(n, 5, 4, 4).astype(np.float32)
    np.testing.assert_allclose(
        tdisc.minibatch_stddev(torch.from_numpy(x)).numpy(),
        np.asarray(jdisc.minibatch_stddev(jnp.asarray(x))), rtol=1e-6,
        atol=1e-6)


def test_discriminator_and_its_gradients_match_jax(dnets):
    size, jp, tp = dnets
    x = np.tanh(np.random.RandomState(size + 1).randn(4, 3, size, size)
                ).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(jdisc.discriminator_apply(params, xx) *
                       jnp.arange(1.0, 5.0)[:, None])

    jl = jdisc.discriminator_apply(jp, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: (jax.tree_util.tree_map(lambda t: t.requires_grad_(True), v)
              if isinstance(v, dict) else v) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = tdisc.discriminator_apply(tp, tx)
    (tl * torch.arange(1.0, 5.0)[:, None]).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    close(tl.detach().numpy(), jl)
    close(tx.grad.numpy(), jgx)
    grads = _flat({k: jax.tree_util.tree_map(lambda t: t.grad, v)
                   if isinstance(v, dict) else v.grad for k, v in tp.items()})
    want = _flat(jax.device_get(jgp))
    assert sorted(grads) == sorted(want)
    for k in want:
        close(grads[k], want[k])


def test_discriminator_init_is_seeded_and_matches_jax_shapes():
    a = tdisc.init_discriminator_params(torch.Generator().manual_seed(0),
                                        size=32, device="cpu")
    b = tdisc.init_discriminator_params(torch.Generator().manual_seed(0),
                                        size=32, device="cpu")
    _assert_trees_equal(a, params_to_numpy(b))
    want = jdisc.init_discriminator_params(jax.random.PRNGKey(0), size=32)
    fa, fw = _flat(a), _flat(want)
    assert {k: v.shape for k, v in fa.items()} == \
        {k: np.asarray(v).shape for k, v in fw.items()}


def test_d_params_from_rosinality_matches_jax():
    jp = jdisc.init_discriminator_params(jax.random.PRNGKey(9), size=16)
    state = {"convs.0.0.weight": jp["stem"]["weight"],
             "convs.0.1.bias": jp["stem"]["bias"],
             "final_conv.0.weight": jp["final_conv"]["weight"],
             "final_conv.1.bias": jp["final_conv"]["bias"],
             "final_linear.0.weight": jp["final_linear1"]["weight"],
             "final_linear.0.bias": jp["final_linear1"]["bias"],
             "final_linear.1.weight": jp["final_linear2"]["weight"],
             "final_linear.1.bias": jp["final_linear2"]["bias"]}
    for idx, r in enumerate((16, 8), start=1):
        bp = jp[f"block{r}"]
        state[f"convs.{idx}.conv1.0.weight"] = bp["conv1"]["weight"]
        state[f"convs.{idx}.conv1.1.bias"] = bp["conv1"]["bias"]
        state[f"convs.{idx}.conv2.1.weight"] = bp["conv2"]["weight"]
        state[f"convs.{idx}.conv2.2.bias"] = bp["conv2"]["bias"]
        state[f"convs.{idx}.skip.1.weight"] = bp["skip_weight"]
    state = {k: np.asarray(v) for k, v in state.items()}
    _assert_trees_equal(tdisc.d_params_from_rosinality(state, 16, "cpu"),
                        jdisc.d_params_from_rosinality(state, 16))
