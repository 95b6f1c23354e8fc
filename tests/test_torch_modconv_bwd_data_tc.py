"""B4's tensor-core arithmetic and its split plan, on the CPU.

B4 (`csrc/modconv_bwd_data.cu`) computes the fused layer's data gradient;
its transposed convolution is B3's implicit GEMM (`csrc/modconv_igemm.cuh`)
with CI and CO swapped and the taps flipped, in 3xTF32: dz·d and the
flipped, transposed w are each split into two TF32 values (`tf32_split`)
and three TF32 products (small·big, big·small, big·big) stand for each fp32
product, summed per chunk of FW_KC output channels and the chunks added in
fp32. `fused_layer_bwd_data_3xtf32` emulates that arithmetic in torch ops:
its dx and ds_direct stay within a tenth of B4's gate, 1e-5 relative L2
per output, of float64, where one TF32 pass misses the gate. It also agrees
with the JAX package's Pallas kernel (`_bwd_data_call`, interpret mode,
fp32 operands) at the plain backward's tolerance (rtol 1e-5, atol
1e-5·max|ref|, as `test_bwd_data_plain_matches_pallas_call`).

B4's plan is `fwd_plan` with the roles swapped (M = CI, K = CO). It is
checked at the full-width FFHQ-256 conv1 shapes at batch 4, the odd and
clamp shapes of `chip_smoke.py` and its ragged B4 shapes: the blocks cover
every (input channel, pixel, output channel) exactly once. At small shapes
the per-split partials, each summed over its own blocks' channels and
chunks with their halos, add up to the plain dxmod.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from stylemc_tpu.ops.pallas import modconv_pallas as jmc
from stylemc_torch.bench import fused_layer_ab
from stylemc_torch.ops.kernels import modconv
from test_torch_modconv import _clamped, _mk, _pallas_bwd_inputs
from torch_threads import one_torch_thread  # noqa: F401

GAIN = float(np.sqrt(2))
SMS = 132   # the H100's multiprocessors
NAMES = ("dx", "ds_direct", "dd", "db")


def _inputs(n, ci, co, h, wd, seed=0, x_scale=1.0):
    """dy, y, x, w, s, d, noise, b: the JAX tests' scales (x·600 makes the
    clamp bind), y the plain forward's in float32."""
    rs = np.random.RandomState(seed)
    x, w, s, noise, b = [torch.from_numpy(a.astype(np.float32)) for a in (
        rs.randn(n, ci, h, wd) * x_scale, rs.randn(co, ci, 3, 3) * 0.3,
        rs.randn(n, ci) * 0.7 + 1.0, rs.randn(h, wd) * 0.1,
        rs.randn(co) * 0.2)]
    d, _ = modconv.dcoefs(w, s)
    y = modconv.fused_layer_fwd_plain(x, w, s, d, noise, b, GAIN, 256.0)
    dy = torch.from_numpy(rs.randn(n, co, h, wd).astype(np.float32))
    return dy, y, x, w, s, d, noise, b


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


@pytest.mark.parametrize("shape,x_scale", [
    ((3, 16, 8, 24, 20), 1.0),
    ((2, 64, 32, 16, 16), 600.0),
    ((3, 96, 96, 4, 4), 1.0),
], ids=["odd_24x20", "clamp_binds", "ragged_4x4_c96"])
def test_3xtf32_keeps_the_gate_and_1xtf32_does_not(shape, x_scale):
    args = _inputs(*shape, seed=1, x_scale=x_scale)
    exact = modconv.fused_layer_bwd_data_plain(
        *(t.double() for t in args), GAIN, 256.0)
    three = modconv.fused_layer_bwd_data_3xtf32(*args, GAIN, 256.0)
    one = modconv.fused_layer_bwd_data_3xtf32(*args, GAIN, 256.0, passes=1)
    gate = chip_smoke.MODCONV_REL_L2
    for name, got, want in zip(NAMES, three, exact):
        assert _rel(got, want) <= gate / 10, name
    # one TF32 pass: the convolution's outputs miss the gate
    for name, got, want in list(zip(NAMES, one, exact))[:2]:
        assert _rel(got, want) > gate, name
    if x_scale != 1.0:
        y = args[1]
        assert bool((y.abs() >= 256.0).any()), "clamp never bound"
    with pytest.raises(ValueError, match="passes"):
        modconv.fused_layer_bwd_data_3xtf32(*args, GAIN, 256.0, passes=2)


@pytest.mark.parametrize("case", [_mk, _clamped], ids=["mk", "clamp_active"])
def test_3xtf32_matches_the_pallas_kernel(case):
    x, w, s, noise, b = case()
    n, ci, h, w_sp = x.shape
    dy, y, d, flat = _pallas_bwd_inputs(x, w, s, noise, b)
    _, wt = jmc._prep(jnp.asarray(w))
    dxf, ds, dd, db, _ = jmc._bwd_data_call(
        flat["dyf"], flat["yf"], jnp.asarray(x).reshape(n, ci, h * w_sp), wt,
        jnp.asarray(s), d, flat["noise_f"], jnp.asarray(b).reshape(-1, 1), h,
        GAIN, 256.0, jnp.float32)
    want = (np.asarray(dxf).reshape(x.shape), np.asarray(ds)[:, :, 0],
            np.asarray(dd)[:, :, 0], np.asarray(db)[:, :, 0])
    got = modconv.fused_layer_bwd_data_3xtf32(
        *(torch.from_numpy(np.array(a)) for a in (dy, y, x, w, s, d, noise,
                                                  b)), GAIN, 256.0)
    for name, g, a in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(a).max()),
                                   err_msg=name)


PLAN_SHAPES = (
    [(f"conv1_{res}_n4", 4, c, c, res, res)
     for c, res in fused_layer_ab.layer_shapes()]
    + [(name, n, ci, co, h, w)
       for name, n, ci, co, h, w, _ in chip_smoke.MODCONV_EXTRA]
    + [(name, n, ci, co, h, w)
       for name, n, ci, co, h, w, _ in chip_smoke.MODCONV_DX_RAGGED])


@pytest.mark.parametrize("case,n,ci,co,h,w", PLAN_SHAPES,
                         ids=[c[0] for c in PLAN_SHAPES])
def test_plan_covers_every_channel_and_pixel_once(case, n, ci, co, h, w):
    # B4's roles: the M tiles are input channels, the K range output ones
    plan = modconv.fwd_plan(n, co, ci, h, w, SMS)
    assert (plan.co, plan.ci) == (ci, co)
    assert plan.chunk_cols % 8 == 0    # an n8 fragment is 8 pixels of a row
    assert 1 <= plan.splits <= plan.ci_chunks
    tiles = plan.units * plan.tiles_co
    if tiles <= SMS:
        assert plan.blocks <= SMS
        assert tiles * (plan.splits + 1) > SMS \
            or plan.splits == plan.ci_chunks
    else:
        assert plan.splits == 1
    ci_seen = np.zeros(ci, np.int32)
    pixels = np.zeros((n, h, w), np.int32)
    co_seen = np.zeros(co, np.int32)
    for tile in range(plan.tiles_co):
        (c0, c1), _, _ = plan.block(0, tile, 0)
        assert c0 < c1
        ci_seen[c0:c1] += 1
    for u in range(plan.units):
        _, (n_u, i0, j0), _ = plan.block(u, 0, 0)
        assert 0 <= n_u < n and 0 <= i0 < h and 0 <= j0 < w
        pixels[n_u, i0:i0 + plan.chunk_rows, j0:j0 + plan.chunk_cols] += 1
    for z in range(plan.splits):
        _, _, (k0, k1) = plan.block(0, 0, z)
        assert k0 < k1 and k0 % modconv.FW_KC == 0
        co_seen[k0:k1] += 1
    assert (ci_seen == 1).all() and (pixels == 1).all() \
        and (co_seen == 1).all()
    # the split weight: (big, small) pairs for whole CO chunks and CI tiles
    assert plan.wsplit_floats == 2 * 9 * plan.ci_chunks * modconv.FW_KC \
        * plan.tiles_co * modconv.FW_W_ROW
    # the conv1s at 4²-16² split CO: 32 tiles x 4 splits at 4² (C 512)
    if case == "conv1_4_n4":
        assert (tiles, plan.splits) == (32, 4)


def _partials_by_plan(dz_d, wt, plan):
    """[splits, N, CI, H, W]: each split's dxmod over its output channels,
    built block by block, every chunk read with its one-pixel halo from the
    zero-padded dz·d, as the kernel stages it; wt is the flipped,
    transposed weight [CI, CO, 3, 3]."""
    n, co, h, wd = dz_d.shape
    ci = wt.shape[0]
    zpad = F.pad(dz_d, (1, 1, 1, 1))
    out = torch.zeros((plan.splits, n, ci, h, wd), dtype=dz_d.dtype)
    for z in range(plan.splits):
        for u in range(plan.units):
            for tile in range(plan.tiles_co):
                (c0, c1), (n_u, i0, j0), (k0, k1) = plan.block(u, tile, z)
                i1 = min(h, i0 + plan.chunk_rows)
                j1 = min(wd, j0 + plan.chunk_cols)
                win = zpad[n_u:n_u + 1, k0:k1, i0:i1 + 2, j0:j1 + 2]
                out[z, n_u, c0:c1, i0:i1, j0:j1] = F.conv2d(
                    win, wt[c0:c1, k0:k1])[0]
    return out


@pytest.mark.parametrize("shape", [(3, 8, 16, 24, 20), (3, 72, 40, 4, 4),
                                   (2, 16, 24, 9, 13)],
                         ids=["odd", "plane4_ragged_tiles", "w13"])
def test_plan_partials_sum_to_the_plain_dxmod(shape):
    dy, y, _, w, _, d, _, _ = (t.double() for t in _inputs(*shape, seed=3))
    n, ci, co, h, wd = shape
    plan = modconv.fwd_plan(n, co, ci, h, wd, sms=SMS)
    assert plan.splits > 1
    dz_d = dy * modconv._act_grad(y, GAIN, 256.0) * d[:, :, None, None]
    got = _partials_by_plan(dz_d, w.transpose(0, 1).flip(2, 3), plan).sum(
        dim=0)
    want = F.conv_transpose2d(dz_d, w, padding=1)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
