"""Parity of stylemc_torch.ops with stylemc_tpu.ops on the CPU (fp32).

Same numpy inputs through the JAX op and its torch counterpart; forward
values and first-order gradients agree to rtol 1e-5, atol 1e-6 (fp32
summation order is the only difference). The ToRGB upsample kernel's plain
version is held against the Pallas kernel run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stylemc_tpu import ops as jops
from stylemc_tpu.ops.pallas.upfirdn2d_pallas import (
    _canonical_taps as jax_canonical_taps, upsample2d_pallas)
from stylemc_torch import ops as tops
from stylemc_torch.ops.kernels.upfirdn2d import (
    _canonical_taps, _upsample_taps, upsample2d_kernel, upsample2d_plain)

RTOL, ATOL = 1e-5, 1e-6


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _check_fn_and_grad(jax_fn, torch_fn, *inputs, rtol=RTOL, atol=ATOL):
    """Forward values, then d(sum(y·v))/d(inputs) for a fixed random v."""
    want = np.asarray(jax_fn(*[jnp.asarray(a) for a in inputs]))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = torch_fn(*ts)
    assert tuple(got.shape) == want.shape
    _close(got, want, rtol, atol)

    v = _rand(99, *want.shape)
    jgrads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * v),
                      argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    tgrads = torch.autograd.grad((got * torch.from_numpy(v)).sum(), ts)
    for g_t, g_j in zip(tgrads, jgrads):
        _close(g_t, g_j, rtol, atol)


# --------------------------------------------------------------- upfirdn2d

FILTERS = {
    "binomial4": ([1, 3, 3, 1], {}),
    "separable8": ([1, 2, 3, 4, 4, 3, 2, 1], {"separable": True}),
    "box2": ([1, 1], {}),
}

UPFIRDN_CASES = [
    ("upsample2d", {}),
    ("upsample2d", {"padding": 1}),
    ("downsample2d", {}),
    ("downsample2d", {"padding": (1, 0, 2, 1)}),
    ("filter2d", {}),
    ("upfirdn2d", {"up": 2, "padding": (1, 2, 0, 1)}),
    ("upfirdn2d", {"down": 2, "padding": -1}),
    ("upfirdn2d", {"up": (2, 1), "down": (1, 2), "padding": (2, 1, 1, 2),
                   "flip_filter": True, "gain": 3.0}),
]


@pytest.mark.parametrize("fname", sorted(FILTERS))
@pytest.mark.parametrize("op,kw", UPFIRDN_CASES)
def test_upfirdn2d_family_matches_jax(op, kw, fname):
    taps, fkw = FILTERS[fname]
    fj = jops.setup_filter(taps, **fkw)
    ft = tops.setup_filter(taps, **fkw)
    _close(ft, fj)
    x = _rand(0, 2, 3, 12, 10)
    _check_fn_and_grad(lambda a: getattr(jops, op)(a, fj, **kw),
                       lambda a: getattr(tops, op)(a, ft, **kw), x)


def test_setup_filter_variants_match_jax():
    for args in ([1, 3, 3, 1], [[1, 2], [3, 4]], 2.0):
        for kw in ({}, {"flip_filter": True}, {"gain": 4},
                   {"normalize": False}):
            _close(tops.setup_filter(args, **kw), jops.setup_filter(args, **kw))
            np.testing.assert_array_equal(tops.setup_filter_np(args, **kw),
                                          jops.setup_filter_np(args, **kw))


# ----------------------------------------------------------------- bias_act


@pytest.mark.parametrize("act", sorted(jops.activation_funcs))
def test_bias_act_matches_jax(act):
    assert tops.activation_funcs[act].def_alpha == \
        jops.activation_funcs[act].def_alpha
    assert tops.activation_funcs[act].def_gain == \
        jops.activation_funcs[act].def_gain
    x, b = _rand(1, 2, 5, 4, 3), _rand(2, 5)
    for kw in ({}, {"gain": 0.5, "clamp": 0.7}, {"alpha": 0.1}):
        _check_fn_and_grad(
            lambda a, bb: jops.bias_act(a, bb, act=act, **kw),
            lambda a, bb: tops.bias_act(a, bb, act=act, **kw), x, b)


def test_bias_act_other_dim_and_no_bias():
    x, b = _rand(3, 4, 6), _rand(4, 6)
    _check_fn_and_grad(lambda a, bb: jops.bias_act(a, bb, dim=1, act="lrelu"),
                       lambda a, bb: tops.bias_act(a, bb, dim=1, act="lrelu"),
                       x, b)
    _check_fn_and_grad(lambda a: jops.bias_act(a, act="swish", clamp=1.0),
                       lambda a: tops.bias_act(a, act="swish", clamp=1.0), x)


# ---------------------------------------------------------- conv2d_resample

CONV_CASES = [
    # (up, down, padding, groups, flip_weight, flip_filter, up_impl, use_f)
    (2, 1, 1, 1, False, False, "polyphase", True),
    (2, 1, 1, 1, False, False, "pad_dilate", True),
    (2, 1, 0, 1, True, True, "polyphase", True),
    (2, 1, 1, 1, True, False, None, False),
    (2, 1, 1, 2, False, False, "polyphase", True),
    (1, 2, 1, 1, True, False, None, True),
    (1, 2, 0, 2, True, False, None, True),
    (1, 1, 1, 1, True, False, None, False),
    (1, 1, (1, 0, 2, 1), 1, False, False, None, False),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_resample_matches_jax(case):
    up, down, padding, groups, flip_w, flip_f, impl, use_f = case
    fj = jops.setup_filter([1, 3, 3, 1]) if use_f else None
    ft = tops.setup_filter([1, 3, 3, 1]) if use_f else None
    x, w = _rand(4, 2, 4, 8, 8), _rand(5, 6, 4 // groups, 3, 3)
    kw = dict(up=up, down=down, padding=padding, groups=groups,
              flip_weight=flip_w, flip_filter=flip_f, up_impl=impl)
    _check_fn_and_grad(
        lambda a, ww: jops.conv2d_resample(a, ww, f=fj, **kw),
        lambda a, ww: tops.conv2d_resample(a, ww, f=ft, **kw), x, w,
        atol=1e-5)


def test_up_conv_impls_agree():
    f = tops.setup_filter([1, 3, 3, 1])
    x, w = torch.from_numpy(_rand(6, 2, 4, 7, 5)), torch.from_numpy(
        _rand(7, 3, 4, 3, 3))
    ys = [tops.conv2d_resample(x, w, f=f, up=2, padding=1, flip_weight=False,
                               up_impl=impl)
          for impl in ("polyphase", "pad_dilate")]
    _close(ys[0], ys[1].numpy(), atol=1e-5)


# --------------------------------------------------------- modulated_conv2d

@pytest.mark.parametrize("up,impl", [(1, None), (2, "polyphase"),
                                     (2, "pad_dilate")])
@pytest.mark.parametrize("demodulate,with_noise", [(True, True),
                                                   (True, False),
                                                   (False, False)])
def test_modulated_conv2d_matches_jax(up, impl, demodulate, with_noise):
    fj = jops.setup_filter([1, 3, 3, 1])
    ft = tops.setup_filter([1, 3, 3, 1])
    x, w, s = _rand(8, 2, 4, 6, 6), _rand(9, 5, 4, 3, 3), _rand(10, 2, 4)
    res = 6 * up
    noise = _rand(11, 1, 1, res, res) if with_noise else None
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=up == 1,
              up_impl=impl)
    _check_fn_and_grad(
        lambda a, ww, ss: jops.modulated_conv2d(
            a, ww, ss, noise=None if noise is None else jnp.asarray(noise),
            resample_filter=fj, **kw),
        lambda a, ww, ss: tops.modulated_conv2d(
            a, ww, ss, noise=None if noise is None else torch.from_numpy(noise),
            resample_filter=ft, **kw),
        x, w, s, atol=1e-5)


def test_modulated_conv2d_bf16_prenormalisation():
    x, w, s = _rand(12, 2, 4, 6, 6), _rand(13, 5, 4, 3, 3), _rand(14, 2, 4)
    want = np.asarray(jops.modulated_conv2d(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(s),
        padding=1).astype(jnp.float32))
    got = tops.modulated_conv2d(torch.tensor(x, dtype=torch.bfloat16),
                                torch.from_numpy(w), torch.from_numpy(s),
                                padding=1)
    assert got.dtype == torch.bfloat16
    # bf16 keeps 8 mantissa bits; the two frameworks round at other places
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05, atol=0.05)


def test_fma():
    a, b, c = _rand(15, 3, 4), _rand(16, 3, 4), _rand(17, 3, 4)
    _check_fn_and_grad(jops.fma, tops.fma, a, b, c)


# ------------------------------------------------- the ToRGB upsample kernel

TAPS = _canonical_taps(np.asarray(tops.setup_filter([1, 3, 3, 1])), 4.0,
                       False)


@pytest.mark.parametrize("shape", [(2, 3, 16, 128), (1, 1, 256, 128)])
def test_upsample2d_plain_matches_pallas_interpret(shape):
    x = _rand(20, *shape)
    f = jops.setup_filter([1, 3, 3, 1])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(upsample2d_pallas(jnp.asarray(x), f, force=True))
    got = upsample2d_plain(torch.from_numpy(x), TAPS)
    _close(got, want)


@pytest.mark.parametrize("h", [4, 8, 16, 32])
def test_upsample2d_kernel_cpu_matches_upsample2d(h):
    x = _rand(21, 2, 3, h, h)
    fn = tops.setup_filter_np([1, 3, 3, 1])
    before = upsample2d_kernel.launches
    got = upsample2d_kernel(torch.from_numpy(x), fn)
    assert upsample2d_kernel.launches == before  # the CPU path launches nothing
    _close(got, jops.upsample2d(jnp.asarray(x), jops.setup_filter([1, 3, 3, 1])))
    _close(got, tops.upsample2d(torch.from_numpy(x), fn).numpy())


def test_upsample2d_plain_gradient_matches_jax():
    x = _rand(22, 1, 2, 8, 6)
    fj = jops.setup_filter([1, 3, 3, 1])
    _check_fn_and_grad(lambda a: jops.upsample2d(a, fj),
                       lambda a: upsample2d_plain(a, TAPS), x)


@pytest.mark.parametrize("f,gain,flip", [
    ([1, 3, 3, 1], 4.0, False),
    ([1, 2, 3, 4], 4.0, False),
    ([1, 2, 3, 4], 1.0, True),
    (np.outer([1, 2, 3, 4], [1, 2, 3, 4]) / 100.0, 4.0, False),
    (np.eye(4), 1.0, False),
    ([1, 2, 1], 4.0, False),
])
def test_canonical_taps_match_jax(f, gain, flip):
    assert _canonical_taps(np.asarray(f, np.float32), gain, flip) == \
        jax_canonical_taps(np.asarray(f, np.float32), gain, flip)


def test_upsample2d_kernel_refuses_what_it_does_not_take():
    fn = tops.setup_filter_np([1, 3, 3, 1])
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError):
        upsample2d_kernel(x, np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError):
        upsample2d_kernel(x, np.ones(3, np.float32))
    with pytest.raises(TypeError):
        upsample2d_kernel(x.double(), fn)
    with pytest.raises(ValueError):
        upsample2d_kernel(x.transpose(2, 3), fn)
    with pytest.raises(ValueError):
        upsample2d_kernel(x[0], fn)


def test_upsample2d_kernel_checks_each_filter_once():
    fn = tops.setup_filter_np([1, 3, 3, 1])
    x = torch.from_numpy(_rand(23, 1, 3, 4, 4))
    _upsample_taps.cache_clear()
    first = upsample2d_kernel(x, fn)
    second = upsample2d_kernel(x, torch.from_numpy(fn))
    info = _upsample_taps.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert _upsample_taps(fn.shape, fn.astype(np.float64).tobytes()) == TAPS
    torch.testing.assert_close(first, second, rtol=0, atol=0)
