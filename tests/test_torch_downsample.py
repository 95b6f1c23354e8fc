"""B2, the 2x downsample, and the autograd wiring of B1 and B2, on the CPU.

`downsample2d_plain` (the CUDA kernel's arithmetic in torch ops) is held
against the Pallas kernel `downsample2d_pallas` run in interpret mode, at
rtol 1e-5 / atol 1e-6 (fp32 summation order). First- and second-order
gradients through `upsample2d_kernel` and `downsample2d_kernel` (each a
`torch.autograd.Function` whose backward is the other with reversed taps)
are held against `jax.grad` of the Pallas wrappers at the same tolerance
as `tests/test_pallas.py`. On the CPU the Functions run the plain versions;
the same Functions launch the kernels on the card
(`test_downsample_kernel_matches_plain_on_cuda` in test_torch_isolation.py,
which imports no JAX, so it runs on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from stylemc_tpu import ops as jops
from stylemc_tpu.ops.pallas.upfirdn2d_pallas import (
    downsample2d_pallas, upsample2d_pallas)
from stylemc_torch import ops as tops
from stylemc_torch.ops.kernels.upfirdn2d import (
    _canonical_taps, downsample2d_kernel, downsample2d_plain,
    upsample2d_kernel, upsample2d_plain)
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
FN = tops.setup_filter_np([1, 3, 3, 1])
DOWN_TAPS = _canonical_taps(FN, 1.0, False)
UP_TAPS = _canonical_taps(FN, 4.0, False)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _pallas(fn, x):
    with pltpu.force_tpu_interpret_mode():
        return fn(x, jops.setup_filter([1, 3, 3, 1]), force=True)


# [1,1,512,256] is the two-row-tile plane of the Pallas kernel's grid
@pytest.mark.parametrize("shape", [(2, 3, 16, 256), (1, 2, 32, 256),
                                   (1, 1, 512, 256)])
def test_downsample2d_plain_matches_pallas_interpret(shape):
    x = _rand(30, *shape)
    want = np.asarray(_pallas(downsample2d_pallas, jnp.asarray(x)))
    got = downsample2d_plain(torch.from_numpy(x), DOWN_TAPS)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("shape", [(4, 3, 8, 8), (4, 3, 256, 256),
                                   (2, 5, 6, 10)])
def test_downsample2d_kernel_cpu_matches_downsample2d(shape):
    x = torch.from_numpy(_rand(31, *shape))
    before = downsample2d_kernel.launches
    got = downsample2d_kernel(x, FN)
    assert downsample2d_kernel.launches == before  # the CPU path launches nothing
    _close(got, tops.downsample2d(x, FN))
    _close(got, jops.downsample2d(jnp.asarray(x.numpy()),
                                  jops.setup_filter([1, 3, 3, 1])))


def _grad_pair(jax_loss, torch_loss, x):
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    got, = torch.autograd.grad(torch_loss(t), t)
    return got, want


@pytest.mark.parametrize("shape", [(2, 3, 16, 128), (1, 1, 256, 128)])
def test_upsample_kernel_gradient_matches_pallas(shape):
    x = _rand(32, *shape)
    got, want = _grad_pair(
        lambda z: jnp.sum(_pallas(upsample2d_pallas, z) ** 2),
        lambda z: torch.sum(upsample2d_kernel(z, FN) ** 2), x)
    _close(got, want, rtol=1e-4, atol=1e-5)


def test_downsample_kernel_gradient_matches_pallas():
    y = _rand(33, 1, 2, 32, 256)
    got, want = _grad_pair(
        lambda z: jnp.sum(_pallas(downsample2d_pallas, z) ** 2),
        lambda z: torch.sum(downsample2d_kernel(z, FN) ** 2), y)
    _close(got, want, rtol=1e-4, atol=1e-5)


def _hvp_torch(fn, x, v):
    t = torch.tensor(x, requires_grad=True)
    g, = torch.autograd.grad(torch.sum(fn(t) ** 3), t, create_graph=True)
    h, = torch.autograd.grad(torch.sum(g * torch.from_numpy(v)), t)
    return h


@pytest.mark.parametrize("op", ["up", "down"])
def test_second_order_gradients_match_pallas(op):
    # the two kernels are each other's VJP: second-order gradients chain
    # up → down → up (and down → up → down)
    pallas = upsample2d_pallas if op == "up" else downsample2d_pallas
    kernel = upsample2d_kernel if op == "up" else downsample2d_kernel
    shape = (1, 1, 8, 128) if op == "up" else (1, 1, 16, 256)
    x = _rand(34, *shape)
    v = np.ones_like(x)

    def loss_p(z):
        return jnp.sum(_pallas(pallas, z) ** 3)

    want = jax.grad(lambda z: jnp.vdot(jax.grad(loss_p)(z), v))(
        jnp.asarray(x))
    got = _hvp_torch(lambda t: kernel(t, FN), x, v)
    _close(got, want, rtol=1e-4, atol=1e-4)


def test_backward_is_the_other_op_with_reversed_taps():
    x = torch.from_numpy(_rand(35, 2, 3, 8, 12)).requires_grad_(True)
    g = torch.from_numpy(_rand(36, 2, 3, 16, 24))
    dx, = torch.autograd.grad(upsample2d_kernel(x, FN), x, g)
    torch.testing.assert_close(dx, downsample2d_plain(g, UP_TAPS[::-1]),
                               rtol=0, atol=0)

    y = torch.from_numpy(_rand(37, 2, 3, 16, 24)).requires_grad_(True)
    gy = torch.from_numpy(_rand(38, 2, 3, 8, 12))
    dy, = torch.autograd.grad(downsample2d_kernel(y, FN), y, gy)
    torch.testing.assert_close(dy, upsample2d_plain(gy, DOWN_TAPS[::-1]),
                               rtol=0, atol=0)


def test_backward_takes_a_non_contiguous_cotangent():
    # `img + torgb` can hand the upsample a broadcast cotangent
    x = torch.from_numpy(_rand(39, 1, 3, 4, 4)).requires_grad_(True)
    y = upsample2d_kernel(x, FN)
    g = torch.ones((1, 3, 1, 1)).expand(1, 3, 8, 8)
    assert not g.is_contiguous()
    dx, = torch.autograd.grad(y, x, g)
    _close(dx, downsample2d_plain(g.contiguous(), UP_TAPS[::-1]))


def test_downsample2d_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError, match="even"):
        downsample2d_kernel(torch.zeros(1, 3, 7, 8), FN)
    with pytest.raises(ValueError):
        downsample2d_kernel(x, np.eye(4, dtype=np.float32))
    with pytest.raises(TypeError):
        downsample2d_kernel(x.double(), FN)
    with pytest.raises(ValueError):
        downsample2d_kernel(x.transpose(2, 3), FN)
    with pytest.raises(ValueError, match="device"):
        downsample2d_kernel(torch.empty((1, 3, 4, 4), device="meta"), FN)


def test_chip_smoke_downsample_yardstick_and_bound():
    taps = (0.1, 0.5, 0.9, 0.3)  # asymmetric: pins the tap orientation
    x = torch.from_numpy(_rand(40, 2, 5, 6, 10))
    weight = chip_smoke.library_weight(taps[::-1], 5, "cpu")
    torch.testing.assert_close(chip_smoke.library_downsample(x, weight),
                               downsample2d_plain(x, taps), rtol=0,
                               atol=1e-6)
    ms, by = chip_smoke.downsample_bound((4, 3, 256, 256))
    assert by == "bytes"
    # 3.1 MB in + 0.8 MB out at 3.35 TB/s ≈ 1.2 µs
    assert abs(ms - 5 * 4 * 3 * 256 * 256 / 3.35e12 * 1e3) < 1e-12

