"""B3's tensor-core arithmetic and its split plan, on the CPU.

B3 (`csrc/modconv_fwd.cu`) computes the fused layer's forward on the tensor
cores in 3xTF32: x·s and w are each split into two TF32 values
(`tf32_split`) and three TF32 products (small·big, big·small, big·big)
stand for each fp32 product, summed per chunk of FW_KC input channels and
the chunks added in fp32. `fused_layer_fwd_3xtf32` emulates that
arithmetic in torch ops: it stays within a tenth of B3's gate,
2e-5·max(1, max|z|) (z the pre-clamp output), of float64, where one TF32
pass misses the gate. It also agrees with the JAX package's Pallas kernel
(`_fwd_call`, interpret mode, fp32 operands) at the fused layer's forward
tolerance (rtol/atol 2e-5, as `test_forward_matches_jax_fused`).

`fwd_plan` (the wrapper's division of y among blocks, which the kernel
follows) is checked at the full-width FFHQ-256 conv1 shapes at batch 4 and
16, the odd and clamp shapes of `chip_smoke.py` and its ragged B3 shapes:
the blocks cover every (output channel, pixel, input channel) exactly once.
At small shapes the per-split partials, each summed over its own blocks'
channels and chunks with their halos, add up to the plain pre-activation.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from stylemc_tpu.ops.pallas import modconv_pallas as jmc
from stylemc_torch.bench import fused_layer_ab
from stylemc_torch.ops.kernels import modconv
from torch_threads import one_torch_thread  # noqa: F401

GAIN = float(np.sqrt(2))
SMS = 132   # the H100's multiprocessors


def _inputs(n, ci, co, h, w, seed=0, x_scale=1.0):
    """x, w, s, noise, b at the JAX tests' scales (x·600 makes the clamp
    bind)."""
    rs = np.random.RandomState(seed)
    arrays = (rs.randn(n, ci, h, w) * x_scale, rs.randn(co, ci, 3, 3) * 0.3,
              rs.randn(n, ci) * 0.7 + 1.0, rs.randn(h, w) * 0.1,
              rs.randn(co) * 0.2)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _fwd64(x, w, s, noise, b, clamp):
    x, w, s, noise, b = (t.double() for t in (x, w, s, noise, b))
    d, _ = modconv.dcoefs(w, s)
    return modconv.fused_layer_fwd_plain(x, w, s, d, noise, b, GAIN, clamp)


@pytest.mark.parametrize("shape,x_scale", [
    ((3, 16, 8, 24, 20), 1.0),
    ((2, 64, 32, 16, 16), 600.0),
    ((2, 40, 72, 4, 4), 1.0),
], ids=["odd_24x20", "clamp_binds", "ragged_4x4"])
def test_3xtf32_keeps_the_gate_and_1xtf32_does_not(shape, x_scale):
    x, w, s, noise, b = _inputs(*shape, seed=1, x_scale=x_scale)
    d, _ = modconv.dcoefs(w, s)
    exact = _fwd64(x, w, s, noise, b, 256.0)
    # the gate scales with the pre-clamp output where the clamp binds
    gate = chip_smoke.MODCONV_FWD_TOL * max(
        1.0, float(_fwd64(x, w, s, noise, b, None).abs().max()))
    three = modconv.fused_layer_fwd_3xtf32(x, w, s, d, noise, b, GAIN, 256.0)
    one = modconv.fused_layer_fwd_3xtf32(x, w, s, d, noise, b, GAIN, 256.0,
                                         passes=1)
    assert float((three.double() - exact).abs().max()) <= gate / 10
    assert float((one.double() - exact).abs().max()) > gate
    if x_scale != 1.0:
        assert bool((exact.abs() >= 256.0).any()), "clamp never bound"
    with pytest.raises(ValueError, match="passes"):
        modconv.fused_layer_fwd_3xtf32(x, w, s, d, noise, b, GAIN, 256.0,
                                       passes=2)


def test_3xtf32_matches_the_pallas_kernel():
    x, w, s, noise, b = (t.numpy() for t in _inputs(2, 8, 16, 16, 128,
                                                     seed=2))
    n, ci, h, w_sp = x.shape
    jw, js = jnp.asarray(w), jnp.asarray(s)
    d, _ = jmc._dcoefs(jw, js)
    taps, _ = jmc._prep(jw)
    yflat = jmc._fwd_call(jmc._rowpad_flat(jnp.asarray(x), h, w_sp), taps, js,
                          d, jnp.asarray(noise).reshape(1, h * w_sp),
                          jnp.asarray(b).reshape(-1, 1), h, GAIN, 256.0,
                          jnp.float32)
    want = np.asarray(yflat).reshape(n, w.shape[0], h, w_sp)
    got = modconv.fused_layer_fwd_3xtf32(
        *(torch.from_numpy(np.array(a)) for a in (x, w, s, d, noise, b)),
        GAIN, 256.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


PLAN_SHAPES = (
    [(f"conv1_{res}_n{n}", n, c, c, res, res)
     for n in (4, 16) for c, res in fused_layer_ab.layer_shapes()]
    + [(name, n, ci, co, h, w)
       for name, n, ci, co, h, w, _ in chip_smoke.MODCONV_EXTRA]
    + [(name, n, ci, co, h, w)
       for name, n, ci, co, h, w, _ in chip_smoke.MODCONV_FWD_RAGGED]
    + [("ci3_co5_5x5", 1, 3, 5, 5, 5)])


@pytest.mark.parametrize("case,n,ci,co,h,w", PLAN_SHAPES,
                         ids=[c[0] for c in PLAN_SHAPES])
def test_plan_covers_every_channel_and_pixel_once(case, n, ci, co, h, w):
    plan = modconv.fwd_plan(n, ci, co, h, w, SMS)
    assert plan.chunk_rows == modconv.FW_CHUNK_ROWS
    assert plan.chunk_cols % 8 == 0    # an n8 fragment is 8 pixels of a row
    assert 1 <= plan.splits <= plan.ci_chunks
    # one block per SM in one wave where the chunks leave room for splits
    tiles = plan.units * plan.tiles_co
    if tiles <= SMS:
        assert plan.blocks <= SMS
        assert tiles * (plan.splits + 1) > SMS \
            or plan.splits == plan.ci_chunks
    else:
        assert plan.splits == 1
    # every (co, pixel, ci) in exactly one block: the grid is the product of
    # the CO tiles, the pixel chunks and the CI splits, each a partition
    co_seen = np.zeros(co, np.int32)
    pixels = np.zeros((n, h, w), np.int32)
    ci_seen = np.zeros(ci, np.int32)
    for tile in range(plan.tiles_co):
        (c0, c1), _, _ = plan.block(0, tile, 0)
        assert c0 < c1
        co_seen[c0:c1] += 1
    for u in range(plan.units):
        _, (n_u, i0, j0), _ = plan.block(u, 0, 0)
        assert 0 <= n_u < n and 0 <= i0 < h and 0 <= j0 < w
        pixels[n_u, i0:i0 + plan.chunk_rows, j0:j0 + plan.chunk_cols] += 1
    for z in range(plan.splits):
        _, _, (k0, k1) = plan.block(0, 0, z)
        assert k0 < k1 and k0 % modconv.FW_KC == 0
        ci_seen[k0:k1] += 1
    assert (co_seen == 1).all() and (pixels == 1).all() \
        and (ci_seen == 1).all()
    # the split weight holds (big, small) pairs for whole channel chunks
    # and CO tiles, each row the tile's channels and their padding, so the
    # kernel's weight copies need no bounds
    assert modconv.FW_W_ROW >= modconv.FW_BLOCK_CO
    assert plan.wsplit_floats == 2 * 9 * plan.ci_chunks * modconv.FW_KC \
        * plan.tiles_co * modconv.FW_W_ROW


def _partials_by_plan(x, w, s, plan):
    """[splits, N, CO, H, W]: each split's pre-activation over its input
    channels, built block by block, every chunk read with its one-pixel
    halo from the zero-padded x·s, as the kernel stages it."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    xpad = F.pad(x * s[:, :, None, None], (1, 1, 1, 1))
    out = torch.zeros((plan.splits, n, co, h, wd), dtype=x.dtype)
    for z in range(plan.splits):
        for u in range(plan.units):
            for tile in range(plan.tiles_co):
                (c0, c1), (n_u, i0, j0), (k0, k1) = plan.block(u, tile, z)
                i1 = min(h, i0 + plan.chunk_rows)
                j1 = min(wd, j0 + plan.chunk_cols)
                win = xpad[n_u:n_u + 1, k0:k1, i0:i1 + 2, j0:j1 + 2]
                out[z, n_u, c0:c1, i0:i1, j0:j1] = F.conv2d(
                    win, w[c0:c1, k0:k1])[0]
    return out


@pytest.mark.parametrize("shape", [(3, 16, 8, 24, 20), (3, 40, 72, 4, 4),
                                   (2, 24, 16, 9, 13)],
                         ids=["odd", "plane4_ragged_tiles", "w13"])
def test_plan_partials_sum_to_the_plain_preactivation(shape):
    x, w, s, _, _ = (t.double() for t in _inputs(*shape, seed=3))
    plan = modconv.fwd_plan(*shape, sms=SMS)
    assert plan.splits > 1
    got = _partials_by_plan(x, w, s, plan).sum(dim=0)
    want = F.conv2d(x * s[:, :, None, None], w, padding=1)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_every_library_lists_the_headers_it_includes():
    """The build hashes each library's SOURCES: every header a .cu file
    includes is among them, so an edit to it rebuilds the library."""
    for name in modconv.KERNELS:
        cu, *headers = modconv.SOURCES[name]
        included = set(re.findall(r'#include "([^"]+)"', cu.read_text()))
        assert included == {h.name for h in headers}, name
        assert all(h.exists() for h in headers)
