"""The fused modulated synthesis layer as CUDA kernels: B3 (forward), B4
(backward to x, styles, the demodulation coefficients and the bias) and B5
(backward to the weight). Counterpart of
`stylemc_tpu/ops/pallas/modconv_pallas.py`.

`fused_modulated_layer` is one StyleGAN2 synthesis layer body for up=1, a
3x3 kernel and padding 1: modulate, convolve, demodulate, add noise and
bias, lrelu(0.2)·gain, clamp. It runs the plain versions below for CPU
tensors and launches `csrc/modconv_{fwd,bwd_data,bwd_weight}.cu` for CUDA
tensors, or raises. Its backward (`_FusedLayer`) launches B5 only when the
weight needs a gradient, so a frozen generator (find_direction, serving)
never pays for dW; the chain through d = rsqrt(s²·ΣW² + 1e-8) runs in plain
torch outside the kernels, as in the JAX wrapper.

B3, B4 and B5 run on the tensor cores in 3xTF32 (`fused_layer_fwd_3xtf32`,
`fused_layer_bwd_data_3xtf32` and `fused_layer_bwd_weight_3xtf32` emulate
their arithmetic for the tests) over the splits that `fwd_plan` and
`bwd_weight_plan` lay out. B3 and B4 share one mainloop
(`csrc/modconv_igemm.cuh`): B4's transposed convolution is B3's implicit
GEMM with CI and CO swapped and the taps flipped, planned by `fwd_plan`
with the roles swapped.

`launch_fwd.launches`, `launch_bwd_data.launches` and
`launch_bwd_weight.launches` count the calls of each kernel; B3 is up to
three CUDA launches (the weight split, the main kernel, the reduction of
its CI splits) and B4 four (the dz pass, the weight split, the transposed
convolution, and the reduction of its ds partials or CO splits), each
counted once.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

LRELU_SLOPE = 0.2

_CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("modconv_fwd", "modconv_bwd_data", "modconv_bwd_weight")
# each library's .cu file and the headers it includes (hashed, not compiled)
SOURCES = {
    "modconv_fwd": (_CSRC / "modconv_fwd.cu", _CSRC / "modconv_igemm.cuh",
                    _CSRC / "modconv_tc.cuh"),
    "modconv_bwd_data": (_CSRC / "modconv_bwd_data.cu",
                         _CSRC / "modconv_common.cuh",
                         _CSRC / "modconv_igemm.cuh",
                         _CSRC / "modconv_tc.cuh"),
    "modconv_bwd_weight": (_CSRC / "modconv_bwd_weight.cu",
                           _CSRC / "modconv_common.cuh",
                           _CSRC / "modconv_tc.cuh"),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "stylemc_modconv_fwd": [_P] * 9 + [_I] * 5 + [_F, _F] + [_I] * 4 + [_P],
    "stylemc_modconv_bwd_data": [_P] * 16 + [_I] * 5 + [_F, _F] + [_I] * 4
    + [_P],
    "stylemc_modconv_bwd_weight": [_P] * 6 + [_I] * 5 + [_F, _F] + [_I] * 4
    + [_P],
}


# ------------------------------------------------------------ plain versions


def dcoefs(w: torch.Tensor, styles: torch.Tensor):
    """(d, w2): the demodulation coefficients d = rsqrt(s²·ΣW² + 1e-8)
    [N, CO] and w2 = Σ_taps W² [CO, CI]."""
    w2 = w.square().sum(dim=(2, 3))
    return torch.rsqrt(styles.square() @ w2.T + 1e-8), w2


def _act_grad(y: torch.Tensor, gain: float, clamp: Optional[float]):
    """d(clamp(lrelu(z)·gain))/dz read off the output y: 0 where the clamp
    binds (|y| >= clamp), else gain or gain·0.2 by the sign of y."""
    g = torch.full_like(y, gain * LRELU_SLOPE).masked_fill_(y >= 0, gain)
    if clamp is not None:
        g = g.masked_fill(y.abs() >= clamp, 0.0)
    return g


def fused_layer_fwd_plain(x, w, styles, d, noise, bias, gain: float,
                          clamp: Optional[float]):
    """B3's function in torch ops: s and d (`dcoefs`) folded into
    per-sample taps, one grouped convolution over the batch, then noise,
    bias, lrelu·gain and the clamp. x [N,CI,H,W], w [CO,CI,3,3], styles
    [N,CI], d [N,CO], noise [H,W], bias [CO] → y [N,CO,H,W]."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    wm = w[None] * styles[:, None, :, None, None] * d[:, :, None, None, None]
    acc = F.conv2d(x.reshape(1, n * ci, h, wd),
                   wm.reshape(n * co, ci, 3, 3), padding=1,
                   groups=n).reshape(n, co, h, wd)
    z1 = acc + noise + bias[:, None, None]
    y = torch.where(z1 >= 0, z1, z1 * LRELU_SLOPE) * gain
    return y if clamp is None else y.clamp(-clamp, clamp)


def fused_layer_bwd_data_plain(dy, y, x, w, styles, d, noise, bias,
                               gain: float, clamp: Optional[float]):
    """B4's function in torch ops: (dx, ds_direct, dd, db). dz = dy·g(y);
    dxmod is the transposed convolution of dz with the taps scaled by d (a
    grouped conv_transpose2d over the batch); dx = dxmod·s, ds_direct =
    Σ dxmod·x, db = Σ dz and dd = (Σ dz·z1 − b·Σ dz − Σ dz·noise)/d with
    z1 rebuilt from y, each summed over the plane."""
    n, co, h, wd = dy.shape
    ci = w.shape[1]
    dz = dy * _act_grad(y, gain, clamp)
    wt = w[None] * d[:, :, None, None, None]
    dxmod = F.conv_transpose2d(dz.reshape(1, n * co, h, wd),
                               wt.reshape(n * co, ci, 3, 3), padding=1,
                               groups=n).reshape(n, ci, h, wd)
    dx = dxmod * styles[:, :, None, None]
    ds_direct = (dxmod * x).sum(dim=(2, 3))
    a = y / gain
    z1 = torch.where(a >= 0, a, a / LRELU_SLOPE)
    db = dz.sum(dim=(2, 3))
    t1 = (dz * z1).sum(dim=(2, 3))
    t3 = (dz * noise).sum(dim=(2, 3))
    dd = (t1 - bias * db - t3) / d
    return dx, ds_direct, dd, db


def fused_layer_bwd_weight_plain(dy, y, x, styles, d, gain: float,
                                 clamp: Optional[float]):
    """B5's function in torch ops: dW[co,ci,t] = Σ_n Σ_px (dz·d)[n,co,px] ·
    (x·s)[n,ci,px+off_t], the scales applied inside the per-n sum, as one
    matrix product over the unfolded input. → [CO,CI,3,3]."""
    n, co, h, wd = dy.shape
    ci = x.shape[1]
    dzd = dy * _act_grad(y, gain, clamp) * d[:, :, None, None]
    cols = F.unfold(x * styles[:, :, None, None], 3, padding=1)
    dw = torch.einsum("nop,nkp->ok", dzd.reshape(n, co, h * wd), cols)
    return dw.reshape(co, ci, 3, 3)


# ---------------------------- the tensor-core kernels' arithmetic, emulated


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    # sign-magnitude bits: adding half of the 13 dropped bits' unit rounds
    # the magnitude to nearest, ties away from zero
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 `v` as B3, B4 and B5 split their operands:
    big = cvt.rna.tf32.f32(v) (round to nearest, ties away from zero, to 10
    mantissa bits) and small = cvt.rna.tf32.f32(v − big)."""
    big = _tf32_round(v)
    return big, _tf32_round(v - big)


def fused_layer_bwd_weight_3xtf32(dy, y, x, styles, d, gain: float,
                                  clamp: Optional[float], passes: int = 3):
    """B5's function with B5's arithmetic (csrc/modconv_bwd_weight.cu), in
    torch ops on float32: dz = dy·g(y) and the unfolded x split by
    `tf32_split`, the products small·big, big·small and big·big summed in
    float32 per sample (a product of two TF32 values is exact in float32),
    then each sample's [CO, CI] sum scaled by d[n,co]·s[n,ci] and the
    samples added. passes=1 keeps big·big alone: one TF32 pass. Tests use
    it; no path of the port does. → [CO,CI,3,3]."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    n, co, h, wd = dy.shape
    ci = x.shape[1]
    a_big, a_small = tf32_split((dy * _act_grad(y, gain, clamp))
                                .reshape(n, co, h * wd))
    b_big, b_small = tf32_split(F.unfold(x, 3, padding=1))
    pairs = [(a_big, b_big)] if passes == 1 else [
        (a_small, b_big), (a_big, b_small), (a_big, b_big)]
    per_n = sum(torch.einsum("nop,nkp->nok", a, b) for a, b in pairs)
    scale = d[:, :, None] * styles.repeat_interleave(9, dim=1)[:, None, :]
    return (per_n * scale).sum(dim=0).reshape(co, ci, 3, 3)


# B3's chunk of input channels (B4's of output channels), as
# csrc/modconv_igemm.cuh fixes it
FW_KC = 8


def fused_layer_fwd_3xtf32(x, w, styles, d, noise, bias, gain: float,
                           clamp: Optional[float], passes: int = 3):
    """B3's function with B3's arithmetic (csrc/modconv_fwd.cu), in torch
    ops on float32: x·s and w split by `tf32_split`, the products
    small·big, big·small and big·big of each chunk of FW_KC input channels
    (all nine taps) summed in float32, the chunks' sums added in order,
    then d, noise, bias, lrelu·gain and the clamp. passes=1 keeps big·big
    alone: one TF32 pass. Tests use it; no path of the port does.
    → y [N,CO,H,W]."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    x_big, x_small = tf32_split(x * styles[:, :, None, None])
    w_big, w_small = tf32_split(w)
    pairs = [(w_big, x_big)] if passes == 1 else [
        (w_small, x_big), (w_big, x_small), (w_big, x_big)]
    acc = None
    for c0 in range(0, x.shape[1], FW_KC):
        part = sum(F.conv2d(b[:, c0:c0 + FW_KC], a[:, c0:c0 + FW_KC],
                            padding=1) for a, b in pairs)
        acc = part if acc is None else acc + part
    z1 = acc * d[:, :, None, None] + noise + bias[:, None, None]
    y = torch.where(z1 >= 0, z1, z1 * LRELU_SLOPE) * gain
    return y if clamp is None else y.clamp(-clamp, clamp)


def fused_layer_bwd_data_3xtf32(dy, y, x, w, styles, d, noise, bias,
                                gain: float, clamp: Optional[float],
                                passes: int = 3):
    """B4's function with B4's arithmetic (csrc/modconv_bwd_data.cu), in
    torch ops on float32: dz·d and the flipped, transposed w split by
    `tf32_split`, the products small·big, big·small and big·big of each
    chunk of FW_KC output channels (all nine taps) summed in float32, the
    chunks' sums added in order into dxmod; then dx = dxmod·s and
    ds_direct = Σ dxmod·x. dd and db come from the dz pass, which has no
    products for the tensor cores: `fused_layer_bwd_data_plain`'s. passes=1
    keeps big·big alone: one TF32 pass. Tests use it; no path of the port
    does. → (dx, ds_direct, dd, db)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    dz = dy * _act_grad(y, gain, clamp)
    a_big, a_small = tf32_split(dz * d[:, :, None, None])
    # the transposed convolution as a convolution: [CI, CO, 3, 3], flipped
    w_big, w_small = tf32_split(w.transpose(0, 1).flip(2, 3))
    pairs = [(w_big, a_big)] if passes == 1 else [
        (w_small, a_big), (w_big, a_small), (w_big, a_big)]
    dxmod = None
    for c0 in range(0, dy.shape[1], FW_KC):
        part = sum(F.conv2d(b[:, c0:c0 + FW_KC], a[:, c0:c0 + FW_KC],
                            padding=1) for a, b in pairs)
        dxmod = part if dxmod is None else dxmod + part
    _, _, dd, db = fused_layer_bwd_data_plain(dy, y, x, w, styles, d, noise,
                                              bias, gain, clamp)
    return (dxmod * styles[:, :, None, None], (dxmod * x).sum(dim=(2, 3)),
            dd, db)


# ------------------------------------------------------ B3's and B4's plan

# B3's block tile (B4's: 64 input channels), the rows of its pixel chunk
# and the pairs of a row of its split weight (the tile's 64 channels and 4
# of padding), as csrc/modconv_igemm.cuh fixes them
FW_BLOCK_CO = 64
FW_CHUNK_ROWS = 16
FW_W_ROW = 68


@dataclass(frozen=True)
class FwdPlan:
    """How B3 divides y among blocks. The grid is (pixel chunks, CO tiles,
    splits): chunk u is one (sample, chunk_rows × chunk_cols pixel chunk),
    numbered n-major then chunk row then chunk column; the input channels
    are cut into chunks of FW_KC, and split z sums chunks
    [chunks·z // splits, chunks·(z+1) // splits) into partial z. With one
    split the kernel writes y; with more, a reduction sums the partials in
    split order.

    B4's transposed convolution runs the same GEMM with the roles swapped,
    planned by `fwd_plan(n, co, ci, h, w, sms)`: there `ci` is the layer's
    CO (the K range that splits cut) and `co` its CI (the M tiles)."""

    n: int
    ci: int
    co: int
    h: int
    w: int
    chunk_cols: int
    splits: int

    @property
    def chunk_rows(self) -> int:
        return FW_CHUNK_ROWS

    @property
    def tiles_co(self) -> int:
        return -(-self.co // FW_BLOCK_CO)

    @property
    def ci_chunks(self) -> int:
        return -(-self.ci // FW_KC)

    @property
    def chunk_grid(self) -> Tuple[int, int]:
        """(rows, columns) of pixel chunks over one plane."""
        return -(-self.h // self.chunk_rows), -(-self.w // self.chunk_cols)

    @property
    def units(self) -> int:
        rows, cols = self.chunk_grid
        return self.n * rows * cols

    @property
    def blocks(self) -> int:
        return self.units * self.tiles_co * self.splits

    @property
    def wsplit_floats(self) -> int:
        """Floats of the split weight: (big, small) pairs [CO tiles][CI_pad]
        [9][FW_W_ROW], CI_pad rounded up to FW_KC."""
        return self.tiles_co * self.ci_chunks * FW_KC * 9 * FW_W_ROW * 2

    def unit(self, u: int) -> Tuple[int, int, int]:
        """(n, i0, j0): the sample and top-left pixel of chunk u."""
        rows, cols = self.chunk_grid
        n, rc = divmod(u, rows * cols)
        return n, (rc // cols) * self.chunk_rows, (rc % cols) * self.chunk_cols

    def ci_range(self, z: int) -> Tuple[int, int]:
        """The input channels [begin, end) that split z sums."""
        begin = self.ci_chunks * z // self.splits
        end = self.ci_chunks * (z + 1) // self.splits
        return FW_KC * begin, min(self.ci, FW_KC * end)

    def block(self, u: int, tile: int, z: int):
        """What block (u, tile, z) covers: ((co begin, co end), (n, i0, j0),
        (ci begin, ci end)), clipped to the layer."""
        co0 = tile * FW_BLOCK_CO
        return ((co0, min(self.co, co0 + FW_BLOCK_CO)), self.unit(u),
                self.ci_range(z))


def fwd_plan(n: int, ci: int, co: int, h: int, w: int, sms: int) -> FwdPlan:
    """B3's plan on a card with `sms` multiprocessors (one 256-thread block
    fits on each): chunks of 16 rows × 16 columns (16 × 8 for planes at
    most 8 wide), and where the (chunk, CO tile) blocks leave SMs idle, as many
    CI splits as fill them once, at most one channel chunk per split."""
    cols = 8 if w <= 8 else 16
    plan = FwdPlan(n, ci, co, h, w, cols, 1)
    splits = max(1, min(sms // (plan.units * plan.tiles_co),
                        plan.ci_chunks))
    return FwdPlan(n, ci, co, h, w, cols, splits)


# ------------------------------------------------------------ B5's split plan

# B5's block tile and pixel chunk, as csrc/modconv_bwd_weight.cu fixes them
BW_BLOCK_CO = 64
BW_BLOCK_CI = 32
BW_CHUNK_PIXELS = 128


@dataclass(frozen=True)
class BwdWeightPlan:
    """How B5 divides dW among blocks. The grid is (CO tiles, CI tiles,
    splits); the (n, pixel) reduction is cut into units, one (sample,
    chunk_rows × chunk_cols pixel chunk) each, numbered n-major then chunk
    row then chunk column, and split z sums units
    [units·z // splits, units·(z+1) // splits) into partial z."""

    n: int
    ci: int
    co: int
    h: int
    w: int
    chunk_cols: int
    splits: int

    @property
    def chunk_rows(self) -> int:
        return BW_CHUNK_PIXELS // self.chunk_cols

    @property
    def tiles_co(self) -> int:
        return -(-self.co // BW_BLOCK_CO)

    @property
    def tiles_ci(self) -> int:
        return -(-self.ci // BW_BLOCK_CI)

    @property
    def chunk_grid(self) -> Tuple[int, int]:
        """(rows, columns) of pixel chunks over one plane."""
        return -(-self.h // self.chunk_rows), -(-self.w // self.chunk_cols)

    @property
    def units(self) -> int:
        rows, cols = self.chunk_grid
        return self.n * rows * cols

    def split_range(self, z: int) -> Tuple[int, int]:
        return (self.units * z // self.splits,
                self.units * (z + 1) // self.splits)

    def unit(self, u: int) -> Tuple[int, int, int]:
        """(n, i0, j0): the sample and top-left pixel of unit u."""
        rows, cols = self.chunk_grid
        n, rc = divmod(u, rows * cols)
        return n, (rc // cols) * self.chunk_rows, (rc % cols) * self.chunk_cols


def bwd_weight_plan(n: int, ci: int, co: int, h: int, w: int,
                    sms: int) -> BwdWeightPlan:
    """B5's plan on a card with `sms` multiprocessors (one 256-thread block
    fits on each): chunks of 8 rows x 16 columns (16 x 8 for planes at most
    8 wide), and as
    many splits as fill the SMs once beside the (CO, CI) tiles, at least 1
    and at most one unit per split."""
    cols = 8 if w <= 8 else 16
    plan = BwdWeightPlan(n, ci, co, h, w, cols, 1)
    splits = max(1, min(sms // (plan.tiles_co * plan.tiles_ci), plan.units))
    return BwdWeightPlan(n, ci, co, h, w, cols, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------------- kernels


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """The kernel library `name` (one of KERNELS), built from its sources at
    first use."""
    from .build import build_library

    lib = ctypes.CDLL(str(build_library(name, SOURCES[name])))
    for fn, argtypes in _ARGTYPES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _clamp_args(clamp: Optional[float]) -> Tuple[float, int]:
    return (0.0, 0) if clamp is None else (float(clamp), 1)


def _run(name: str, fn: str, device: torch.device, *args) -> None:
    """Call the C entry `fn` of library `name` on the current stream of
    `device` (tensors are passed by data pointer) and raise on a CUDA
    error."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(name), fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch_fwd(x, w, styles, d, noise, bias, gain: float,
               clamp: Optional[float]) -> torch.Tensor:
    """B3 on contiguous float32 CUDA tensors → y [N,CO,H,W], over the split
    that `fwd_plan` lays out; counts one call on `launch_fwd.launches` (the
    weight split, the main kernel and, when the plan splits CI, the
    reduction: up to three CUDA launches)."""
    n, ci, h, wd = x.shape
    co = w.shape[0]
    plan = fwd_plan(n, ci, co, h, wd, _sm_count(x.device.index))
    # 16-byte copies need whole 4-pixel groups and aligned rows
    vec = wd % 4 == 0 and x.data_ptr() % 16 == 0
    wsplit = torch.empty(plan.wsplit_floats, dtype=x.dtype, device=x.device)
    partial = torch.empty((plan.splits, n, co, h, wd), dtype=x.dtype,
                          device=x.device) if plan.splits > 1 else None
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    _run("modconv_fwd", "stylemc_modconv_fwd", x.device, x, w, styles, d,
         noise, bias, wsplit, partial, y, n, ci, co, h, wd, gain,
         *_clamp_args(clamp), plan.splits, plan.chunk_cols, int(vec))
    launch_fwd.launches += 1
    return y


def launch_bwd_data(dy, y, x, w, styles, d, noise, bias, gain: float,
                    clamp: Optional[float]):
    """B4 on contiguous float32 CUDA tensors → (dx, ds_direct, dd, db), as
    `fused_layer_bwd_data_plain`, over the split that `fwd_plan` lays out
    with CI and CO swapped (M = CI, K = CO); counts one call on
    `launch_bwd_data.launches` (the dz pass, the weight split, the main
    kernel and the reduction of its ds partials or CO splits: four CUDA
    launches). Every output, ds_direct included, comes from the kernels."""
    n, co, h, wd = dy.shape
    ci = x.shape[1]
    plan = fwd_plan(n, co, ci, h, wd, _sm_count(x.device.index))
    opts = dict(dtype=x.dtype, device=x.device)
    dz = torch.empty_like(dy)
    # the main kernel stages dz: 16-byte copies need whole 4-pixel groups
    vec = wd % 4 == 0 and dz.data_ptr() % 16 == 0
    wsplit = torch.empty(plan.wsplit_floats, **opts)
    rows, cols = plan.chunk_grid
    partial = torch.empty((plan.splits, n, ci, h, wd), **opts) \
        if plan.splits > 1 else None
    ds_part = torch.empty((n, ci, rows * cols), **opts) \
        if plan.splits == 1 else None
    dx = torch.empty((n, ci, h, wd), **opts)
    ds = torch.empty((n, ci), **opts)
    dd = torch.empty((n, co), **opts)
    db = torch.empty_like(dd)
    _run("modconv_bwd_data", "stylemc_modconv_bwd_data", x.device, dy, y, x,
         w, styles, d, noise, bias, dz, wsplit, partial, ds_part, dx, ds, dd,
         db, n, ci, co, h, wd, gain, *_clamp_args(clamp), plan.splits,
         plan.chunk_cols, int(vec))
    launch_bwd_data.launches += 1
    return dx, ds, dd, db


def launch_bwd_weight(dy, y, x, styles, d, gain: float,
                      clamp: Optional[float]) -> torch.Tensor:
    """B5 on contiguous float32 CUDA tensors → dW's direct term
    [CO,CI,3,3], the sum of the kernel's split partials (`bwd_weight_plan`);
    counts the launch on `launch_bwd_weight.launches`."""
    n, co, h, wd = dy.shape
    ci = x.shape[1]
    plan = bwd_weight_plan(n, ci, co, h, wd, _sm_count(x.device.index))
    # 16-byte copies need whole 4-pixel groups and aligned rows
    vec = wd % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (dy, y, x))
    partial = torch.empty((plan.splits, co, ci, 9), dtype=x.dtype,
                          device=x.device)
    _run("modconv_bwd_weight", "stylemc_modconv_bwd_weight", x.device, dy, y,
         x, styles, d, partial, n, ci, co, h, wd, gain, *_clamp_args(clamp),
         plan.splits, plan.chunk_cols, int(vec))
    launch_bwd_weight.launches += 1
    return partial.sum(dim=0).reshape(co, ci, 3, 3)


launch_fwd.launches = 0
launch_bwd_data.launches = 0
launch_bwd_weight.launches = 0


def _on_device(device: torch.device, kernel, plain, *args):
    """`plain(*args)` for CPU tensors, `kernel(*args)` for CUDA ones."""
    if device.type == "cpu":
        return plain(*args)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return kernel(*args)


# ------------------------------------------------------------------ autograd


class _FusedLayer(torch.autograd.Function):
    """B3 forward; backward B4 (every backward: dW's demodulation term
    needs its dd as well) and B5 only when the weight needs a gradient,
    with the chain through d in plain torch (`_fused_layer_bwd` of the JAX
    package). The noise gets a zero cotangent (see fused_modulated_layer)."""

    @staticmethod
    def forward(ctx, x, w, styles, noise, bias, gain, clamp):
        d, _ = dcoefs(w, styles)
        y = _on_device(x.device, launch_fwd, fused_layer_fwd_plain, x, w,
                       styles, d, noise, bias, gain, clamp)
        ctx.save_for_backward(x, w, styles, noise, bias, y, d)
        ctx.gain, ctx.clamp = gain, clamp
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, styles, noise, bias, y, d = ctx.saved_tensors
        gain, clamp = ctx.gain, ctx.clamp
        need_x, need_w, need_s, need_noise, need_b = ctx.needs_input_grad[:5]
        if dy.dtype != torch.float32:
            raise TypeError(f"expected a float32 cotangent, got {dy.dtype}")
        dy = dy.contiguous()
        dx, ds_direct, dd, db = _on_device(
            x.device, launch_bwd_data, fused_layer_bwd_data_plain, dy, y, x,
            w, styles, d, noise, bias, gain, clamp)
        # d = rsqrt(s² @ w2ᵀ + eps): dσ² = dd·(-1/2)·d³
        w2 = w.square().sum(dim=(2, 3))
        dsig = dd * (-0.5) * d ** 3
        ds = ds_direct + 2.0 * styles * (dsig @ w2) if need_s else None
        dw = None
        if need_w:
            dw = _on_device(x.device, launch_bwd_weight,
                            fused_layer_bwd_weight_plain, dy, y, x, styles,
                            d, gain, clamp)
            dw = dw + 2.0 * w * (styles.square().T @ dsig).T[:, :, None, None]
        return (dx if need_x else None, dw, ds,
                torch.zeros_like(noise) if need_noise else None,
                db.sum(dim=0) if need_b else None, None, None)


def fused_modulated_layer(x, w, styles, noise, bias,
                          gain: float = math.sqrt(2),
                          clamp: Optional[float] = 256.0,
                          mxu: str = "default", force: bool = False,
                          noise_grad: bool = False):
    """The fused synthesis layer (up=1, 3x3, pad 1, demodulate, noise,
    bias, lrelu(0.2)·gain, clamp): CUDA kernels B3/B4/B5 for CUDA tensors,
    the plain versions for CPU tensors; None where the layer is not one it
    computes, and the caller takes the unfused path.

    x [N,CI,H,W]; w [CO,CI,3,3]; styles [N,CI]; noise [H,W] or [1,1,H,W]
    (already scaled by noise_strength); bias [CO]; any floating types.

    Returns None for a w that is not 3x3, for noise that is None or not
    2-D/4-D, for per-sample [N,1,H,W] noise, and when `noise_grad` is True:
    the noise input is not differentiable through this path (its cotangent
    is zero; the JAX contract), so a caller that differentiates the noise
    must take the unfused path.

    The JAX package also declines W % 128 != 0, H < 8, shapes over its VMEM
    budget and non-TPU backends without `force`; those limits are the TPU
    kernel's (Mosaic's lane tiling and VMEM), not the function's, so this
    port runs any plane size (4x4 included) and `force` has no effect.

    Types: as in JAX, the layer computes in float32 whatever the inputs'
    floating types: x, w, styles and bias are cast to float32 before the
    kernels, y comes back in x's type, and autograd casts dx, dw, ds and
    dbias back to their inputs' types (a bf16 x gives a bf16 y and dx).
    `mxu` is "default" or "highest" and both keep fp32 accuracy here: B3,
    B4 and B5 on the tensor cores in 3xTF32. In JAX,
    "default" means bf16 multiplies on the TPU's MXU; a bf16 policy is
    later work.
    """
    if mxu not in ("default", "highest"):
        raise ValueError(f"mxu must be 'default' or 'highest', got {mxu!r}")
    if noise_grad:
        return None
    if w.ndim != 4 or tuple(w.shape[2:]) != (3, 3) or noise is None \
            or noise.ndim not in (2, 4):
        return None
    if noise.ndim == 4:
        if noise.shape[0] != 1 or noise.shape[1] != 1:
            return None
        noise = noise[0, 0]
    for name, t in (("x", x), ("w", w), ("styles", styles), ("bias", bias)):
        if not t.dtype.is_floating_point:
            raise TypeError(f"{name}: expected a floating type, got {t.dtype}")
    n, ci, h, wd = x.shape
    co = w.shape[0]
    if w.shape[1] != ci or tuple(styles.shape) != (n, ci) \
            or tuple(bias.shape) != (co,):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, styles {tuple(styles.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if any(t.device != x.device for t in (w, styles, noise, bias)):
        raise ValueError("x, w, styles, noise and bias must be on one device")
    noise = noise.to(torch.float32).expand(h, wd).contiguous()
    y = _FusedLayer.apply(*(t.to(torch.float32).contiguous()
                            for t in (x, w, styles)), noise,
                          bias.to(torch.float32).contiguous(), float(gain),
                          None if clamp is None else float(clamp))
    return y.to(x.dtype)
