"""B5's tensor-core arithmetic and its split plan, on the CPU.

B5 (`csrc/modconv_bwd_weight.cu`) computes dW on the tensor cores in
3xTF32: each fp32 operand is split into two TF32 values (`tf32_split`, as
`cvt.rna.tf32.f32` rounds) and three TF32 products (small·big, big·small,
big·big) stand for each fp32 product. `fused_layer_bwd_weight_3xtf32`
emulates that arithmetic in torch ops: it stays within 1e-6 relative L2 of
float64 (fp32's own error is ~1e-7 here), where one TF32 pass is ~1e-4 off,
more than B5's 1e-5 gate. It also agrees with the JAX package's Pallas
kernel (`_bwd_weight_call`, interpret mode, mxu 'highest') at that test
file's tolerance.

`bwd_weight_plan` (the wrapper's split of the (n, pixel) reduction, which
the kernel follows) is checked at the full-width FFHQ-256 conv1 shapes, the
odd and clamp shapes of `chip_smoke.py` and its ragged B5 shapes: every
(CO tile, CI tile) meets every (n, pixel chunk) exactly once, the chunks
cover every pixel once, and at small shapes the per-split partials, each
summed over its own units' chunks and halos, add up to the plain dW.
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


def _inputs(n, ci, co, h, w, seed=0):
    """dy, y (scaled so that the clamp binds at some elements), x, s, d."""
    rs = np.random.RandomState(seed)
    arrays = (rs.randn(n, co, h, w), rs.randn(n, co, h, w) * 200.0,
              rs.randn(n, ci, h, w), rs.rand(n, ci) + 0.5,
              rs.rand(n, co) + 0.5)
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


def test_tf32_split_rounds_like_cvt_rna():
    one = 1.0 + 2.0 ** -11          # halfway between two TF32 values
    v = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0, -2.5e-3],
                     dtype=torch.float32)
    big, small = modconv.tf32_split(v)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                         0.0], dtype=torch.float32)
    torch.testing.assert_close(big[:5], want, rtol=0, atol=0)
    # ties round away from zero; the remainder is exact here
    assert float(small[0]) == -(2.0 ** -11) and float(small[2]) == 2.0 ** -12
    r = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32) * 1e3)
    big, small = modconv.tf32_split(r)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # |v − big − small| <= 2^-22 |v|: a half unit of small's last place
    err = (r.double() - big.double() - small.double()).abs()
    assert bool((err <= 2.0 ** -22 * r.double().abs()).all())


@pytest.mark.parametrize("shape", [(2, 8, 16, 16, 16), (3, 16, 8, 24, 20)],
                         ids=["c8_16x16", "odd_24x20"])
def test_3xtf32_keeps_fp32_accuracy_and_1xtf32_does_not(shape):
    dy, y, x, s, d = _inputs(*shape, seed=1)
    exact = modconv.fused_layer_bwd_weight_plain(
        dy.double(), y.double(), x.double(), s.double(), d.double(), GAIN,
        256.0)
    three = modconv.fused_layer_bwd_weight_3xtf32(dy, y, x, s, d, GAIN, 256.0)
    one = modconv.fused_layer_bwd_weight_3xtf32(dy, y, x, s, d, GAIN, 256.0,
                                                passes=1)
    assert _rel(three, exact) <= 1e-6
    assert _rel(one, exact) > chip_smoke.MODCONV_REL_L2
    # the clamp bound somewhere, so g(y) was 0 there
    assert bool((y.abs() >= 256.0).any())
    with pytest.raises(ValueError, match="passes"):
        modconv.fused_layer_bwd_weight_3xtf32(dy, y, x, s, d, GAIN, 256.0,
                                              passes=2)


def test_3xtf32_matches_the_pallas_kernel():
    rs = np.random.RandomState(2)
    n, ci, co, h, w_sp = 2, 8, 16, 8, 128
    dy, y, x = (rs.randn(*sh).astype(np.float32) for sh in (
        (n, co, h, w_sp), (n, co, h, w_sp), (n, ci, h, w_sp)))
    y = y * 200.0
    s = (rs.rand(n, ci) + 0.5).astype(np.float32)
    d = (rs.rand(n, co) + 0.5).astype(np.float32)
    taps = jmc._bwd_weight_call(
        jmc._rowpad_flat(jnp.asarray(dy), h, w_sp),
        jmc._rowpad_flat(jnp.asarray(y), h, w_sp),
        jmc._rowpad_flat(jnp.asarray(x), h, w_sp), jnp.asarray(s),
        jnp.asarray(d), h, GAIN, 256.0, ci, jnp.float32)
    want = np.transpose(np.asarray(taps).reshape(3, 3, co, ci), (2, 3, 0, 1))
    got = modconv.fused_layer_bwd_weight_3xtf32(
        *(torch.from_numpy(a) for a in (dy, y, x, s, d)), GAIN, 256.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


PLAN_SHAPES = (
    [(f"conv1_{res}", 4, c, c, res, res)
     for c, res in fused_layer_ab.layer_shapes()]
    + [(name, n, ci, co, h, w)
       for name, n, ci, co, h, w, _ in chip_smoke.MODCONV_EXTRA]
    + [(name, n, ci, co, h, w)
       for name, n, ci, co, h, w, _ in chip_smoke.MODCONV_DW_RAGGED]
    + [("plane4_c16", 3, 16, 16, 4, 4)])


@pytest.mark.parametrize("case,n,ci,co,h,w", PLAN_SHAPES,
                         ids=[c[0] for c in PLAN_SHAPES])
def test_plan_covers_every_tile_and_pixel_once(case, n, ci, co, h, w):
    plan = modconv.bwd_weight_plan(n, ci, co, h, w, SMS)
    assert plan.chunk_rows * plan.chunk_cols == modconv.BW_CHUNK_PIXELS
    assert plan.chunk_cols % 8 == 0    # a k step is 8 pixels of one row
    assert 1 <= plan.splits <= plan.units
    tiles = plan.tiles_co * plan.tiles_ci
    assert (plan.tiles_co - 1) * modconv.BW_BLOCK_CO < co \
        <= plan.tiles_co * modconv.BW_BLOCK_CO
    assert (plan.tiles_ci - 1) * modconv.BW_BLOCK_CI < ci \
        <= plan.tiles_ci * modconv.BW_BLOCK_CI
    # one block per SM in one wave where the tiles leave room for splits
    if tiles <= SMS:
        assert tiles * plan.splits <= SMS
        assert tiles * (plan.splits + 1) > SMS or plan.splits == plan.units
    # every (CO tile, CI tile) x unit in exactly one block, none empty
    seen = np.zeros((plan.tiles_co, plan.tiles_ci, plan.units), np.int32)
    for z in range(plan.splits):
        begin, end = plan.split_range(z)
        assert begin < end
        seen[:, :, begin:end] += 1
    assert (seen == 1).all()
    # the units' chunks cover every pixel of every sample once
    pixels = np.zeros((n, h, w), np.int32)
    for u in range(plan.units):
        n_u, i0, j0 = plan.unit(u)
        assert 0 <= n_u < n and 0 <= i0 < h and 0 <= j0 < w
        pixels[n_u, i0:i0 + plan.chunk_rows, j0:j0 + plan.chunk_cols] += 1
    assert (pixels == 1).all()


def _partials_by_plan(dy, y, x, s, d, plan):
    """[splits, CO, CI, 9]: each split's sum over its units, every chunk
    read with its one-pixel halo from the zero-padded x, as the kernel
    stages it."""
    dzd = dy * modconv._act_grad(y, GAIN, 256.0) * d[:, :, None, None]
    xpad = F.pad(x * s[:, :, None, None], (1, 1, 1, 1))
    h, w = x.shape[2:]
    out = torch.zeros((plan.splits, dy.shape[1], x.shape[1], 9),
                      dtype=dy.dtype)
    for z in range(plan.splits):
        for u in range(*plan.split_range(z)):
            n, i0, j0 = plan.unit(u)
            i1 = min(h, i0 + plan.chunk_rows)
            j1 = min(w, j0 + plan.chunk_cols)
            a = dzd[n, :, i0:i1, j0:j1]
            for t in range(9):
                di, dj = divmod(t, 3)
                b = xpad[n, :, i0 + di:i1 + di, j0 + dj:j1 + dj]
                out[z, :, :, t] += torch.einsum("oij,kij->ok", a, b)
    return out


@pytest.mark.parametrize("shape", [(3, 16, 8, 24, 20), (3, 40, 72, 4, 4),
                                   (2, 24, 16, 9, 13)],
                         ids=["odd", "plane4_ragged_tiles", "w13"])
def test_plan_partials_sum_to_the_plain_dw(shape):
    dy, y, x, s, d = (t.double() for t in _inputs(*shape, seed=3))
    plan = modconv.bwd_weight_plan(*shape, sms=SMS)
    assert plan.splits > 1
    got = _partials_by_plan(dy, y, x, s, d, plan).sum(dim=0)
    want = modconv.fused_layer_bwd_weight_plain(dy, y, x, s, d, GAIN, 256.0)
    assert _rel(got.reshape(want.shape), want) <= 1e-12


def test_c_entry_points_take_the_wrappers_arguments():
    """Each C entry of the fused layer's kernels takes as many arguments as
    the wrapper's ctypes signature passes, and every signature the wrapper
    holds names an entry of one of them (B3's, B4's and B5's)."""
    found = set()
    for name in modconv.KERNELS:
        src = modconv.SOURCES[name][0].read_text()
        for fn, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            assert fn in modconv._ARGTYPES, fn
            assert len(params.split(",")) == len(modconv._ARGTYPES[fn]), fn
            found.add(fn)
    assert found == set(modconv._ARGTYPES)
    # B3: nine tensors (x, w, s, d, noise, bias, the split weight, the
    # partials, y), five sizes, gain and clamp, has_clamp, splits,
    # chunk_cols, vec, the stream
    assert len(modconv._ARGTYPES["stylemc_modconv_fwd"]) == 21
