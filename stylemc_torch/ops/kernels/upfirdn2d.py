"""The 2x FIR upsample (B1) and downsample (B2) as CUDA kernels
(counterparts of `_upsample2x_core` and `_downsample2x_core` in
`stylemc_tpu/ops/pallas/upfirdn2d_pallas.py`).

`upsample2d_kernel` and `downsample2d_kernel` take what `upsample2d` and
`downsample2d` take for the canonical case: a 4-D contiguous float32 tensor
and a separable 4-tap filter. For a CPU tensor they run the plain versions
(`upsample2d_plain`, `downsample2d_plain`); for a CUDA tensor they launch
`csrc/upsample2x.cu` or `csrc/downsample2x.cu`, or raise. Each is a
`torch.autograd.Function` whose backward is the other with reversed taps,
as the JAX custom VJPs are, so a gradient on the card runs both kernels.
`upsample_plan` and `downsample_plan` lay out each launch's threads; the
C entries check the plan and launch it as given.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {name: (_CSRC / f"{name}.cu", _CSRC / "resample2x.cuh")
           for name in ("upsample2x", "downsample2x")}

Taps = Tuple[float, float, float, float]


def _canonical_taps(f, gain: float, flip_filter: bool) -> Optional[Taps]:
    """The 1-D correlation taps upfirdn2d applies for a separable 4-tap
    filter (1-D [4] or rank-1 [4, 4]), with sqrt(gain) per axis; None for
    any other filter."""
    f = np.asarray(f, np.float64)
    if f.ndim == 2:
        u, s, vt = np.linalg.svd(f)
        if s[1] > 1e-6 * s[0] or f.shape != (4, 4):
            return None
        col = u[:, 0] * np.sqrt(s[0])
        row = vt[0] * np.sqrt(s[0])
        if not np.allclose(np.outer(col, row), f, atol=1e-8):
            return None
        if not np.allclose(col, row, atol=1e-8):
            col = np.abs(col)
            row = np.abs(row)
            if not np.allclose(np.outer(col, row), f, atol=1e-7):
                return None
        f1 = col
    else:
        if f.shape[0] != 4:
            return None
        f1 = f
    taps = f1 * np.sqrt(gain)
    if not flip_filter:
        taps = taps[::-1]
    return tuple(float(t) for t in taps)


@functools.lru_cache(maxsize=16)
def _upsample_taps(shape: Tuple[int, ...], data: bytes) -> Taps:
    """`_canonical_taps` of the float64 filter `data` for the 2x upsample,
    computed once per filter: the synthesis passes the same filter on
    every call."""
    taps = _canonical_taps(np.frombuffer(data).reshape(shape), 4.0, False)
    if taps is None:
        raise ValueError("filter is not a separable 4-tap filter")
    return taps


def upsample2d_plain(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: polyphase rows, then columns,
    zero boundary. [N, C, H, W] → [N, C, 2H, 2W]."""
    g0, g1, g2, g3 = taps
    n, c, h, w = x.shape
    xp = F.pad(x, (0, 0, 1, 1))
    even = g0 * xp[:, :, 0:h] + g2 * xp[:, :, 1:h + 1]
    odd = g1 * xp[:, :, 1:h + 1] + g3 * xp[:, :, 2:h + 2]
    v = torch.stack([even, odd], dim=3).reshape(n, c, 2 * h, w)
    vp = F.pad(v, (1, 1))
    even = g0 * vp[..., 0:w] + g2 * vp[..., 1:w + 1]
    odd = g1 * vp[..., 1:w + 1] + g3 * vp[..., 2:w + 2]
    return torch.stack([even, odd], dim=-1).reshape(n, c, 2 * h, 2 * w)


@functools.lru_cache(maxsize=16)
def _downsample_taps(shape: Tuple[int, ...], data: bytes) -> Taps:
    """`_canonical_taps` of the float64 filter `data` for the 2x
    downsample (gain 1), computed once per filter."""
    taps = _canonical_taps(np.frombuffer(data).reshape(shape), 1.0, False)
    if taps is None:
        raise ValueError("filter is not a separable 4-tap filter")
    return taps


def downsample2d_plain(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: stride-2 rows, then columns,
    zero boundary, out[m] = Σ_k taps[k]·x[2m + k - 1].
    [N, C, 2H, 2W] → [N, C, H, W]."""
    g0, g1, g2, g3 = taps
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x, (0, 0, 1, 1))
    v = (g0 * xp[:, :, 0:h:2] + g1 * xp[:, :, 1:h + 1:2]
         + g2 * xp[:, :, 2:h + 2:2] + g3 * xp[:, :, 3:h + 3:2])
    vp = F.pad(v, (1, 1))
    return (g0 * vp[..., 0:w:2] + g1 * vp[..., 1:w + 1:2]
            + g2 * vp[..., 2:w + 2:2] + g3 * vp[..., 3:w + 3:2])


# ------------------------------------------------------ B1's and B2's plans

# as csrc/resample2x.cuh, csrc/upsample2x.cu and csrc/downsample2x.cu take
# them; the C entries refuse a plan with other values
RESAMPLE_THREADS = 128   # threads a block
# rows of the smaller plane a thread walks: one where the plane has at most
# SMALL_PLANE_ROWS rows (the call is a launch and one memory round trip,
# and the shortest chain of work a thread wins), two above it (fewer,
# fuller threads; each row window shared by two rows)
SMALL_PLANE_ROWS = 16
WARP = 32
PLAN_REFUSED = -1        # what a C entry returns for a plan it refuses


@dataclass(frozen=True)
class ResamplePlan:
    """How B1 or B2 divides `planes` planes of (h, w) among threads; (h, w)
    is the smaller plane: B1's input, B2's output. Thread (pair, strip,
    plane) owns columns 2·pair and 2·pair + 1 and rows [strip·rows,
    strip·rows + rows) of it, clipped to the plane: B1 writes the 2×2
    output quads of those input pixels, B2 those output pixels.

    A block is tx column pairs × ty row strips × ps plane slots
    (threadIdx.x, .y, .z) and the grid its tiles: pair = blockIdx.x·tx +
    threadIdx.x, strip = blockIdx.y·ty + threadIdx.y, plane = blockIdx.z·ps +
    threadIdx.z. tx is a power of two no larger than a warp, so a warp holds
    whole segments of tx lanes in one row strip of one plane: a lane's
    shuffle neighbours are its neighbouring column pairs except at the
    segment's first and last lane, which load their halo column themselves.
    Small planes share a block (ps > 1)."""

    planes: int
    h: int
    w: int
    rows: int
    tx: int
    ty: int
    ps: int

    @property
    def pairs(self) -> int:
        return -(-self.w // 2)

    @property
    def strips(self) -> int:
        return -(-self.h // self.rows)

    @property
    def block(self) -> Tuple[int, int, int]:
        return self.tx, self.ty, self.ps

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (-(-self.pairs // self.tx), -(-self.strips // self.ty),
                -(-self.planes // self.ps))

    @property
    def vector(self) -> bool:
        """Whether the 8- and 16-byte path fits the shape (even widths:
        whole column pairs and aligned rows); the pointers' alignment is
        the wrapper's to check."""
        return self.w % 2 == 0

    def launch_args(self) -> Tuple[int, ...]:
        """rows, tx, ty, ps, gx, gy, gz: the plan as the C entries take it."""
        return (self.rows, *self.block, *self.grid)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _resample_plan(planes: int, h: int, w: int) -> ResamplePlan:
    """The plan over `planes` smaller planes of h × w: segments of up to a
    warp of column pairs, then as many row strips as fill the block, then
    as many plane slots."""
    rows = 1 if h <= SMALL_PLANE_ROWS else 2
    pairs, strips = -(-w // 2), -(-h // rows)
    tx = min(_pow2_at_least(pairs), WARP)
    ty = min(_pow2_at_least(strips), RESAMPLE_THREADS // tx)
    return ResamplePlan(planes, h, w, rows, tx, ty,
                        RESAMPLE_THREADS // (tx * ty))


def upsample_plan(planes: int, h: int, w: int) -> ResamplePlan:
    """B1's plan for `planes` input planes of h × w."""
    return _resample_plan(planes, h, w)


def downsample_plan(planes: int, h: int, w: int) -> ResamplePlan:
    """B2's plan for `planes` input planes of h × w (even): the plan over
    its h/2 × w/2 outputs."""
    return _resample_plan(planes, h // 2, w // 2)


# ------------------------------------------------------------------ launches

# the bytes of a thread's widest load of x on the vector path: B1 loads a
# float2 of input columns, B2 a float4
_X_ALIGN = {"upsample2x": 8, "downsample2x": 16}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """The kernel library `name` (upsample2x or downsample2x), built from
    `csrc/<name>.cu` at first use."""
    from .build import build_library

    lib = ctypes.CDLL(str(build_library(name, SOURCES[name])))
    fn = getattr(lib, f"stylemc_{name}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, *[ctypes.c_int] * 8, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(name: str, x: torch.Tensor, out_hw: Tuple[int, int],
            plan: ResamplePlan, taps: Taps) -> torch.Tensor:
    """Launch kernel `name` on contiguous float32 CUDA planes `x` over
    `plan` and return its [N, C, *out_hw] output."""
    n, c = x.shape[:2]
    y = torch.empty((n, c, *out_hw), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    vec = plan.vector and x.data_ptr() % _X_ALIGN[name] == 0
    fn = getattr(_library(name), f"stylemc_{name}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), plan.planes, plan.h, plan.w,
                 *taps, *plan.launch_args(), int(vec), stream)
    if err == PLAN_REFUSED:
        raise ValueError(f"{name}: the kernel refuses {plan} (CUDA's grid "
                         "limits or 32-bit plane offsets)")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y


def launch_upsample(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """B1 on a contiguous float32 CUDA tensor [N, C, H, W] → [N, C, 2H, 2W]
    over `upsample_plan`; counts the launch on
    `upsample2d_kernel.launches`."""
    n, c, h, w = x.shape
    y = _launch("upsample2x", x, (2 * h, 2 * w), upsample_plan(n * c, h, w),
                taps)
    upsample2d_kernel.launches += 1
    return y


def launch_downsample(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """B2 on a contiguous float32 CUDA tensor [N, C, 2H, 2W] → [N, C, H, W]
    over `downsample_plan`; counts the launch on
    `downsample2d_kernel.launches`."""
    n, c, h, w = x.shape
    y = _launch("downsample2x", x, (h // 2, w // 2),
                downsample_plan(n * c, h, w), taps)
    downsample2d_kernel.launches += 1
    return y


def _on_device(x: torch.Tensor, kernel, plain, taps: Taps) -> torch.Tensor:
    """`plain` for a CPU tensor, `kernel` for a CUDA one; raises otherwise."""
    if x.device.type == "cpu":
        return plain(x, taps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return kernel(x, taps)


def _cotangent(g: torch.Tensor) -> torch.Tensor:
    """A cotangent as the kernels take it: float32 and contiguous (the one
    that reaches the ToRGB chain comes from `img + torgb` and may be a
    broadcast view)."""
    if g.dtype != torch.float32:
        raise TypeError(f"expected a float32 cotangent, got {g.dtype}")
    return g.contiguous()


class _Upsample2x(torch.autograd.Function):
    """B1 with B2 as its VJP: the transpose of zero-stuff + filter is filter
    with the reversed taps + stride-2 subsample (`_upsample2x_bwd` of the
    JAX package). The backward calls `_Downsample2x`, whose backward is
    this Function again, so gradients of any order go through the kernels."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps = taps
        return _on_device(x, launch_upsample, upsample2d_plain, taps)

    @staticmethod
    def backward(ctx, g):
        return _Downsample2x.apply(_cotangent(g), ctx.taps[::-1]), None


class _Downsample2x(torch.autograd.Function):
    """B2 with B1 as its VJP: the transpose of the stride-2 correlation is
    the polyphase upsample with the reversed taps (`_downsample2x_bwd`)."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps = taps
        return _on_device(x, launch_downsample, downsample2d_plain, taps)

    @staticmethod
    def backward(ctx, g):
        return _Upsample2x.apply(_cotangent(g), ctx.taps[::-1]), None


def _check_input(x) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 4:
        raise ValueError("expected a 4-D NCHW tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _filter_key(f) -> Tuple[Tuple[int, ...], bytes]:
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f, np.float64)
    return f.shape, f.tobytes()


def upsample2d_kernel(x: torch.Tensor, f) -> torch.Tensor:
    """`upsample2d(x, f)` (up=2, padding 0, gain 1, no flip) for a separable
    4-tap filter `f`: B1 on a CUDA tensor, `upsample2d_plain` on a CPU one,
    differentiable to any order (its VJP is B2, see `_Upsample2x`). Raises
    for anything else. `upsample2d_kernel.launches` counts B1 launches."""
    _check_input(x)
    return _Upsample2x.apply(x, _upsample_taps(*_filter_key(f)))


def downsample2d_kernel(x: torch.Tensor, f) -> torch.Tensor:
    """`downsample2d(x, f)` (down=2, padding 0, gain 1, no flip) for a
    separable 4-tap filter `f` and an even plane size: B2 on a CUDA tensor,
    `downsample2d_plain` on a CPU one, differentiable to any order (its VJP
    is B1, see `_Downsample2x`). Raises for anything else.
    `downsample2d_kernel.launches` counts B2 launches."""
    _check_input(x)
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"expected an even plane size, got {tuple(x.shape)}")
    return _Downsample2x.apply(x, _downsample_taps(*_filter_key(f)))


upsample2d_kernel.launches = 0
downsample2d_kernel.launches = 0
