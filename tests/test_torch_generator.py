"""Parity of the torch generator with the JAX generator on the CPU (fp32).

JAX params from the JAX initialiser are carried over with
`params_from_numpy`; the same numpy latents go through both. mapping,
w_to_s and synthesis agree to atol 1e-4 (fp32 summation order through up to
eighteen layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.models.stylegan2 import generator as tgen
from stylemc_torch.ops.conv2d_resample import DEFAULT_UP_CONV_IMPL
from torch_threads import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-5

CFG_KW = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2)


@pytest.fixture(scope="module")
def nets():
    jcfg = jgen.GeneratorConfig(**CFG_KW)
    jparams = jgen.init_generator_params(jax.random.PRNGKey(0), jcfg)
    # a non-zero w_avg and noise strengths so truncation and const noise
    # are exercised
    jparams["mapping"]["w_avg"] = jnp.asarray(
        np.random.RandomState(7).randn(512).astype(np.float32) * 0.1)
    for bp in jparams["synthesis"].values():
        for name in ("conv0", "conv1"):
            if name in bp:
                bp[name]["noise_strength"] = jnp.asarray(0.3, jnp.float32)
    tparams = params_from_numpy(jparams, "cpu")
    return jcfg, jparams, tgen.GeneratorConfig(**CFG_KW), tparams


def _z(n=2, seed=3):
    return np.random.RandomState(seed).randn(n, 512).astype(np.float32)


def _styles(nets, psi=0.7):
    jcfg, jparams, _, _ = nets
    return np.array(jgen.w_to_s(jparams, jcfg, jgen.mapping(
        jparams, jcfg, jnp.asarray(_z()), truncation_psi=psi)))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("kw", [
    {}, {"img_resolution": 1024}, CFG_KW,
    dict(CFG_KW, low_precision_dtype="bfloat16", num_fp16_res=2),
])
def test_config_matches_jax(kw):
    jc, tc = jgen.GeneratorConfig(**kw), tgen.GeneratorConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.block_resolutions == tc.block_resolutions
    assert jc.num_ws == tc.num_ws and jc.num_style_rows == tc.num_style_rows
    assert jc.temp_shapes() == tc.temp_shapes()
    for res in jc.block_resolutions:
        assert jc.channels(res) == tc.channels(res)
        assert str(jnp.dtype(jc.block_dtype(res))) == \
            str(tc.block_dtype(res)).replace("torch.", "")
    assert tgen.RESOLUTION_UNTIL_K == jgen.RESOLUTION_UNTIL_K
    assert tgen.N_STYLE_CHANNELS == jgen.N_STYLE_CHANNELS
    assert tgen.S_TRAINABLE_SPACE_CHANNELS == jgen.S_TRAINABLE_SPACE_CHANNELS


def test_ffhq256_layout():
    cfg = tgen.GeneratorConfig(img_resolution=256)
    assert cfg.num_ws == 14 and cfg.num_style_rows == 20
    # no form set: every caller, forward-only rendering too, runs polyphase
    assert cfg.up_conv_impl is None
    assert DEFAULT_UP_CONV_IMPL == "polyphase"


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 3)])
def test_mapping_matches_jax(nets, psi, cutoff):
    jcfg, jparams, tcfg, tparams = nets
    want = jgen.mapping(jparams, jcfg, jnp.asarray(_z()), truncation_psi=psi,
                        truncation_cutoff=cutoff)
    got = tgen.mapping(tparams, tcfg, torch.from_numpy(_z()),
                       truncation_psi=psi, truncation_cutoff=cutoff)
    _close(got, want)


def test_split_ws_and_w_to_s_match_jax(nets):
    jcfg, jparams, tcfg, tparams = nets
    ws = np.random.RandomState(4).randn(3, jcfg.num_ws, 512).astype(np.float32)
    for a, b in zip(jgen.split_ws(jcfg, ws), tgen.split_ws(tcfg, ws)):
        np.testing.assert_array_equal(a, b)
    want = jgen.w_to_s(jparams, jcfg, jnp.asarray(ws))
    got = tgen.w_to_s(tparams, tcfg, torch.from_numpy(ws))
    assert tuple(got.shape) == (3, 26, 512)
    _close(got, want)
    assert not got[:, tcfg.num_style_rows:].any()


@pytest.mark.parametrize("impl", [None, "pad_dilate"])
@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_synthesis_matches_jax(nets, impl, noise_mode):
    jcfg, jparams, tcfg, tparams = nets
    jcfg = dataclasses.replace(jcfg, up_conv_impl=impl)
    tcfg = dataclasses.replace(tcfg, up_conv_impl=impl)
    s = _styles(nets)
    want = jgen.synthesis(jparams, jcfg, jnp.asarray(s), noise_mode=noise_mode)
    with torch.inference_mode():
        got = tgen.synthesis(tparams, tcfg, torch.from_numpy(s),
                             noise_mode=noise_mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 32, 32)
    _close(got, want)


def test_synthesis_until_k_and_features_match_jax(nets):
    jcfg, jparams, tcfg, tparams = nets
    s = _styles(nets)
    for until_k in (0, 1, 2):
        jxs, jimg = jgen.synthesis(jparams, jcfg, jnp.asarray(s),
                                   until_k=until_k, return_features=True)
        txs, timg = tgen.synthesis(tparams, tcfg, torch.from_numpy(s),
                                   until_k=until_k, return_features=True)
        assert tuple(timg.shape) == (2, 3, 4 * 2 ** until_k, 4 * 2 ** until_k)
        _close(timg, jimg)
        assert len(txs) == len(jxs) == until_k + 1
        for a, b in zip(txs, jxs):
            _close(a, b)


def test_synthesis_blending_matches_jax(nets):
    jcfg, jparams, tcfg, tparams = nets
    s = _styles(nets)
    s2 = s + 0.5 * np.random.RandomState(5).randn(*s.shape).astype(np.float32)
    jxs, _ = jgen.synthesis(jparams, jcfg, jnp.asarray(s),
                            return_features=True)
    txs, _ = tgen.synthesis(tparams, tcfg, torch.from_numpy(s),
                            return_features=True)
    m8 = np.random.RandomState(6).rand(1, 1, 8, 8).astype(np.float32)
    m16 = [np.random.RandomState(i).rand(2, 1, 16, 16).astype(np.float32)
           for i in (8, 9)]
    want = jgen.synthesis(jparams, jcfg, jnp.asarray(s2), xs_original=jxs,
                          blend_masks={8: jnp.asarray(m8),
                                       16: [jnp.asarray(m) for m in m16]})
    got = tgen.synthesis(tparams, tcfg, torch.from_numpy(s2),
                         xs_original=txs,
                         blend_masks={8: torch.from_numpy(m8),
                                      16: [torch.from_numpy(m) for m in m16]})
    _close(got, want)


def test_synthesis_gradient_matches_jax(nets):
    jcfg, jparams, tcfg, tparams = nets
    s = _styles(nets)
    v = np.random.RandomState(10).randn(2, 3, 32, 32).astype(np.float32)
    want = jax.grad(lambda ss: jnp.sum(jgen.synthesis(jparams, jcfg, ss) * v))(
        jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    (tgen.synthesis(tparams, tcfg, st) * torch.from_numpy(v)).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    _close(st.grad / scale, np.asarray(want) / scale)


def test_remat_is_checkpointing_with_identical_numbers(nets):
    _, _, tcfg, tparams = nets
    s = torch.from_numpy(_styles(nets))
    grads = []
    for c in (tcfg, dataclasses.replace(tcfg, remat=True)):
        st = s.clone().requires_grad_(True)
        tgen.synthesis(tparams, c, st).square().sum().backward()
        grads.append(st.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_random_noise_shape_finite_and_changes(nets):
    _, _, tcfg, tparams = nets
    s = torch.from_numpy(_styles(nets))
    a = tgen.synthesis(tparams, tcfg, s, noise_mode="random",
                       noise_generator=torch.Generator().manual_seed(1))
    b = tgen.synthesis(tparams, tcfg, s, noise_mode="random",
                       noise_generator=torch.Generator().manual_seed(2))
    a2 = tgen.synthesis(tparams, tcfg, s, noise_mode="random",
                        noise_generator=torch.Generator().manual_seed(1))
    const = tgen.synthesis(tparams, tcfg, s, noise_mode="const")
    assert tuple(a.shape) == (2, 3, 32, 32) and torch.isfinite(a).all()
    assert (a - b).abs().max() > 1e-4 and (a - const).abs().max() > 1e-4
    torch.testing.assert_close(a, a2, rtol=0, atol=0)


def test_bf16_policy_close_to_fp32(nets):
    _, _, tcfg, tparams = nets
    s = torch.from_numpy(_styles(nets))
    ref = tgen.synthesis(tparams, tcfg, s)
    lowp = dataclasses.replace(tcfg, low_precision_dtype="bfloat16",
                               num_fp16_res=3)
    got = tgen.synthesis(tparams, lowp, s)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # bf16 keeps 8 mantissa bits in the upper blocks
    assert (got - ref).abs().max() < 0.1 * max(1.0, ref.abs().max())


def test_generate_matches_jax(nets):
    jcfg, jparams, tcfg, tparams = nets
    want = jgen.generate(jparams, jcfg, jnp.asarray(_z()), truncation_psi=0.7)
    got = tgen.generate(tparams, tcfg, torch.from_numpy(_z()),
                        truncation_psi=0.7)
    _close(got, want)


def test_params_roundtrip(nets):
    _, jparams, _, tparams = nets
    back = params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == np.float32
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_init_generator_params_layout_matches_jax():
    jcfg, tcfg = jgen.GeneratorConfig(**CFG_KW), tgen.GeneratorConfig(**CFG_KW)
    jp = jgen.init_generator_params(jax.random.PRNGKey(0), jcfg)
    tp = tgen.init_generator_params(torch.Generator().manual_seed(0), tcfg,
                                    device="cpu")
    tp2 = tgen.init_generator_params(torch.Generator().manual_seed(0), tcfg,
                                     device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     params_to_numpy(tp))
    assert jshapes == tshapes
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(tp)),
                    jax.tree_util.tree_leaves(params_to_numpy(tp2))):
        np.testing.assert_array_equal(a, b)
    # the same run-time scale as the JAX init: unit-ish mapping output
    ws = tgen.mapping(tp, tcfg, torch.from_numpy(_z(8)))
    assert 0.1 < float(ws.std()) < 10.0
