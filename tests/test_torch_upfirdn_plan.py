"""B1's and B2's launch plans and their tiled walk, on the CPU.

`upsample_plan` and `downsample_plan` (ops/kernels/upfirdn2d.py) lay out
the threads of B1 (csrc/upsample2x.cu) and B2 (csrc/downsample2x.cu); the C
entries launch the plan as given. The plans are checked at the ToRGB chain
shapes at batch 1, 4, 16 and 64 (192 planes: the batch-64 serving call),
the 512² plane and odd shapes (odd widths, h not a multiple of the rows a
thread walks, one-row and one-column planes): every output element is
produced by exactly one thread, and the grid is within CUDA's limits.

`_emulate_upsample` and `_emulate_downsample` walk the plan as the kernels
do, in torch ops: each thread's row window loaded before any arithmetic,
the halo columns from the neighbouring lanes of its warp as
`__shfl_up_sync` / `__shfl_down_sync` give them (a lane at a warp's edge
gets its own value back), the lanes at a segment's edge loading theirs
directly, zero outside the plane. The emulation rounds as the plain
versions do (the kernels fuse their multiply-adds, which the card's gate,
1e-5 of the plain version, covers); what it checks is the walk. Each is
held against the plain version (`upsample2d_plain` / `downsample2d_plain`)
at 1e-6, and against the Pallas kernels `_upsample2x_core` /
`_downsample2x_core` in interpret mode at rtol 1e-5 / atol 1e-6 (fp32
summation order), on shapes the Pallas wrappers take.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemc_tpu import ops as jops
from stylemc_tpu.ops.pallas import upfirdn2d_pallas as jup
from stylemc_torch.ops import setup_filter_np
from stylemc_torch.ops.kernels import upfirdn2d as up
from torch_threads import one_torch_thread  # noqa: F401

FN = setup_filter_np([1, 3, 3, 1])
UP_TAPS = up._canonical_taps(FN, 4.0, False)
DOWN_TAPS = up._canonical_taps(FN, 1.0, False)
WARP = 32
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535

CHAIN = [4, 8, 16, 32, 64, 128]
# (planes, h, w) of the smaller plane: B1's input, B2's output
PLAN_CASES = (
    [(b * 3, h, h) for b in (1, 4, 16, 64) for h in CHAIN]
    + [(3, 512, 512)]
    + [(10, 6, 10), (10, 7, 9), (10, 3, 5), (10, 5, 7), (1, 1, 1),
       (2, 1, 8), (3, 5, 1), (7, 9, 66), (1, 13, 3), (5, 33, 17)])


def _plans(planes, h, w):
    """B1's plan for input planes of h × w and B2's for outputs of h × w."""
    return [up.upsample_plan(planes, h, w),
            up.downsample_plan(planes, 2 * h, 2 * w)]


@pytest.mark.parametrize("planes,h,w", PLAN_CASES)
def test_plan_covers_every_output_once_within_cuda_limits(planes, h, w):
    for plan in _plans(planes, h, w):
        tx, ty, ps = plan.block
        gx, gy, gz = plan.grid
        assert tx * ty * ps == up.RESAMPLE_THREADS
        assert tx <= WARP and WARP % tx == 0   # segments never straddle a warp
        assert 1 <= gx <= GRID_X_MAX and 1 <= gy <= GRID_YZ_MAX \
            and 1 <= gz <= GRID_YZ_MAX
        assert 4 * h * w < 2 ** 31              # 32-bit offsets in a plane
        assert plan.vector == (w % 2 == 0)
        assert (plan.h, plan.w) == (h, w)
        assert plan.rows == (1 if h <= up.SMALL_PLANE_ROWS else 2)
        # every pixel of the smaller plane owned by exactly one live thread
        # (B1 writes the 2x2 output quad of each, B2 the pixel itself)
        pair, strip, plane, _ = _threads(plan)
        rows = strip[..., None, None] * plan.rows \
            + torch.arange(plan.rows)[:, None]
        cols = 2 * pair[..., None, None] + torch.arange(2)
        owned = (rows < h) & (cols < w) & (plane[..., None, None] < planes)
        flat = (plane[..., None, None] * h + rows) * w + cols
        counts = torch.bincount(flat[owned], minlength=planes * h * w)
        assert counts.numel() == planes * h * w
        assert bool((counts == 1).all())


def test_plan_shapes_the_chain_as_designed():
    # a warp of column pairs and two rows a thread on the wide planes, one
    # row and plane slots on the small
    up128 = up.upsample_plan(48, 128, 128)
    assert up128.block == (32, 4, 1) and up128.grid == (2, 16, 48)
    assert up128.launch_args() == (2, 32, 4, 1, 2, 16, 48)
    up4 = up.upsample_plan(48, 4, 4)
    assert up4.rows == 1
    assert up4.block == (2, 4, 16) and up4.grid == (1, 1, 3)
    down256 = up.downsample_plan(12, 256, 256)
    assert (down256.h, down256.w, down256.rows) == (128, 128, 2)
    assert down256.block == (32, 4, 1) and down256.grid == (2, 16, 12)
    assert up.upsample_plan(3, 512, 512).grid == (8, 64, 3)
    assert up.downsample_plan(192, 8, 8).grid == (1, 1, 12)


# ------------------------------------------------------------- emulation


def _threads(plan):
    """(pair, strip, plane, threadIdx.x) of every thread, [blocks, threads a
    block], the second axis in CUDA's linear order (x fastest, then y, z),
    so lanes 32·k .. 32·k + 31 of it are warp k."""
    (tx, ty, ps), (gx, gy, gz) = plan.block, plan.grid
    bz, by, bx, z, y, x = torch.meshgrid(
        *(torch.arange(n) for n in (gz, gy, gx, ps, ty, tx)), indexing="ij")
    blocks, threads = gz * gy * gx, ps * ty * tx
    return tuple(t.reshape(blocks, threads) for t in (
        bx * tx + x, by * ty + y, bz * ps + z, x))


def _lane(v):
    return torch.arange(v.shape[1]).view(1, -1, *[1] * (v.dim() - 2)) % WARP


def _shfl_up(v):
    """`__shfl_up_sync(full, v, 1)` along the thread axis: lane i takes lane
    i - 1's value, lane 0 of a warp keeps its own."""
    out = torch.cat([v[:, :1], v[:, :-1]], dim=1)
    return torch.where(_lane(v) == 0, v, out)


def _shfl_down(v):
    out = torch.cat([v[:, 1:], v[:, -1:]], dim=1)
    return torch.where(_lane(v) == WARP - 1, v, out)


def _load(xp, plane, row, col, ok):
    """xp[plane, row, col] where `ok`, else 0 (nothing read)."""
    planes, h, w = xp.shape
    got = xp[plane.clamp(0, planes - 1), row.clamp(0, h - 1),
             col.clamp(0, w - 1)]
    return torch.where(ok, got, torch.zeros(()))


def _store(y, counts, plane, row, col, value, ok):
    index = (plane[ok], row[ok], col[ok])
    y.index_put_(index, value[ok], accumulate=True)
    counts.index_put_(index, torch.ones_like(value[ok], dtype=torch.int32),
                      accumulate=True)


def _emulate_upsample(x, taps, plan):
    """B1's walk over `plan`: [N, C, H, W] → ([N, C, 2H, 2W], writes per
    output element)."""
    g0, g1, g2, g3 = taps
    n, c, h, w = x.shape
    xp = x.reshape(n * c, h, w)
    pair, strip, plane, tid_x = _threads(plan)
    j, r0 = 2 * pair, strip * plan.rows
    live = (j < w) & (r0 < h) & (plane < n * c)
    first, last = tid_x == 0, tid_x == plan.block[0] - 1
    # the window: rows r0-1 .. r0+rows on a trailing axis, loaded up front
    row = r0[..., None] - 1 + torch.arange(plan.rows + 2)
    ok = live[..., None] & (row >= 0) & (row < h)
    p, jj = plane[..., None], j[..., None]
    cx = _load(xp, p, row, jj, ok)
    cy = _load(xp, p, row, jj + 1, ok & (jj + 1 < w))
    left = _load(xp, p, row, jj - 1, ok & first[..., None] & (jj > 0))
    right = _load(xp, p, row, jj + 2, ok & last[..., None] & (jj + 2 < w))
    left = torch.where(first[..., None], left, _shfl_up(cy))
    right = torch.where(last[..., None], right, _shfl_down(cx))
    window = torch.stack([left, cx, cy, right], dim=-1)   # [.., rows+2, 4]

    y = torch.zeros((n * c, 2 * h, 2 * w))
    counts = torch.zeros(y.shape, dtype=torch.int32)
    for k in range(1, plan.rows + 1):
        r = r0 + k - 1
        e = g0 * window[..., k - 1, :] + g2 * window[..., k, :]
        o = g1 * window[..., k, :] + g3 * window[..., k + 1, :]
        for v, dr in ((e, 0), (o, 1)):
            quad = [g0 * v[..., 0] + g2 * v[..., 1],
                    g1 * v[..., 1] + g3 * v[..., 2],
                    g0 * v[..., 1] + g2 * v[..., 2],
                    g1 * v[..., 2] + g3 * v[..., 3]]
            for dc, value in enumerate(quad):
                col = 2 * j + dc
                _store(y, counts, plane, 2 * r + dr, col, value,
                       live & (r < h) & (col < 2 * w))
    return y.reshape(n, c, 2 * h, 2 * w), counts


def _emulate_downsample(x, taps, plan):
    """B2's walk over `plan`: [N, C, 2H, 2W] → ([N, C, H, W], writes per
    output element)."""
    g0, g1, g2, g3 = taps
    n, c, hi, wi = x.shape
    h, w = hi // 2, wi // 2
    xp = x.reshape(n * c, hi, wi)
    pair, strip, plane, tid_x = _threads(plan)
    q, m0 = 2 * pair, strip * plan.rows
    c0 = 2 * q
    live = (q < w) & (m0 < h) & (plane < n * c)
    first, last = tid_x == 0, tid_x == plan.block[0] - 1
    row = 2 * m0[..., None] - 1 + torch.arange(2 * plan.rows + 2)
    ok = live[..., None] & (row >= 0) & (row < hi)
    p, cc = plane[..., None], c0[..., None]
    cols = [_load(xp, p, row, cc + i, ok & (cc + i < wi)) for i in range(4)]
    left = _load(xp, p, row, cc - 1, ok & first[..., None] & (cc > 0))
    right = _load(xp, p, row, cc + 4, ok & last[..., None] & (cc + 4 < wi))
    window = torch.stack([left, *cols, right], dim=-1)   # [.., 2 rows+2, 6]

    y = torch.zeros((n * c, h, w))
    counts = torch.zeros(y.shape, dtype=torch.int32)
    for i in range(plan.rows):
        a, b, cr, d = (window[..., 2 * i + k, :] for k in range(4))
        v = g0 * a + g1 * b + g2 * cr + g3 * d          # vertical pass first
        vl = torch.where(first, v[..., 0], _shfl_up(v[..., 4]))
        vr = torch.where(last, v[..., 5], _shfl_down(v[..., 1]))
        out = [g0 * vl + g1 * v[..., 1] + g2 * v[..., 2] + g3 * v[..., 3],
               g0 * v[..., 2] + g1 * v[..., 3] + g2 * v[..., 4] + g3 * vr]
        r = m0 + i
        for dc, value in enumerate(out):
            _store(y, counts, plane, r, q + dc, value,
                   live & (r < h) & (q + dc < w))
    return y.reshape(n, c, h, w), counts


def _rand(seed, *shape):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


# the chain's planes at batch 1, the odd shapes of chip_smoke.py, one-row
# and one-column planes, h not a multiple of a thread's rows
UP_SHAPES = ([(1, 3, h, h) for h in CHAIN]
             + [(2, 5, 6, 10), (2, 5, 7, 9), (1, 2, 1, 8), (1, 3, 5, 1),
                (1, 2, 9, 66), (1, 2, 33, 10), (1, 1, 17, 7)])
DOWN_SHAPES = ([(1, 3, 2 * h, 2 * h) for h in CHAIN]
               + [(2, 5, 6, 10), (2, 5, 10, 14), (1, 2, 2, 16),
                  (1, 3, 10, 2), (1, 2, 18, 132), (1, 2, 66, 20),
                  (1, 1, 34, 14)])


@pytest.mark.parametrize("shape", UP_SHAPES)
def test_emulated_upsample_walk_matches_plain(shape):
    n, c, h, w = shape
    x = _rand(50, *shape)
    got, counts = _emulate_upsample(x, UP_TAPS,
                                     up.upsample_plan(n * c, h, w))
    assert bool((counts == 1).all())
    torch.testing.assert_close(got, up.upsample2d_plain(x, UP_TAPS),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", DOWN_SHAPES)
def test_emulated_downsample_walk_matches_plain(shape):
    n, c, h, w = shape
    x = _rand(51, *shape)
    got, counts = _emulate_downsample(x, DOWN_TAPS,
                                      up.downsample_plan(n * c, h, w))
    assert bool((counts == 1).all())
    torch.testing.assert_close(got, up.downsample2d_plain(x, DOWN_TAPS),
                               rtol=0, atol=1e-6)


def test_emulated_walks_match_the_pallas_kernels_in_interpret_mode():
    # shapes the Pallas wrappers take (h % 8, w % 128; the downsample's
    # input h % 16, w % 256); asymmetric taps pin their orientation
    taps = (0.1, 0.5, 0.9, 0.3)
    x = _rand(52, 2, 3, 16, 128)
    want = np.asarray(jup._upsample2x_core(jnp.asarray(x.numpy()), taps))
    got, _ = _emulate_upsample(x, taps, up.upsample_plan(6, 16, 128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    x = _rand(53, 1, 2, 32, 256)
    want = np.asarray(jup._downsample2x_core(jnp.asarray(x.numpy()), taps))
    got, _ = _emulate_downsample(x, taps, up.downsample_plan(2, 32, 256))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # and the canonical filter through the JAX op, as the generator calls it
    want = np.asarray(jops.downsample2d(jnp.asarray(x.numpy()),
                                        jops.setup_filter([1, 3, 3, 1])))
    got, _ = _emulate_downsample(x, DOWN_TAPS,
                                 up.downsample_plan(2, 32, 256))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_both_libraries_list_the_header_they_include():
    """The build hashes each library's SOURCES: the plan header both
    kernels include is among them, so an edit to it rebuilds both."""
    for name in ("upsample2x", "downsample2x"):
        cu, *headers = up.SOURCES[name]
        included = set(re.findall(r'#include "([^"]+)"', cu.read_text()))
        assert included == {h.name for h in headers}, name
        assert all(h.exists() for h in headers)
        # the entry launches each number of rows a plan can ask for
        for rows in (1, 2):
            assert f"case {rows}: launch<{rows}>(" in cu.read_text(), name
    header = up.SOURCES["upsample2x"][1].read_text()
    assert f"constexpr int THREADS = {up.RESAMPLE_THREADS};" in header
    assert f"constexpr int PLAN_REFUSED = {up.PLAN_REFUSED};" in header
