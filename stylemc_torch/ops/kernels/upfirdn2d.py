"""The 2x FIR upsample of the ToRGB skip chain as a CUDA kernel
(counterpart of `stylemc_tpu/ops/pallas/upfirdn2d_pallas.py`, whose
`upsample2d_pallas` the generator calls).

`upsample2d_kernel` takes what `upsample2d` takes for the canonical case: a
4-D contiguous float32 tensor and a separable 4-tap filter.
For a CPU tensor it runs `upsample2d_plain`; for a CUDA tensor it launches
`csrc/upsample2x.cu` or raises. Forward only: the backward (the 2x
downsample kernel) is not ported yet, so a CUDA input that requires grad
raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SOURCE = Path(__file__).resolve().parent / "csrc" / "upsample2x.cu"

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


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import build_library

    lib = ctypes.CDLL(str(build_library("upsample2x", [SOURCE])))
    lib.stylemc_upsample2x.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    lib.stylemc_upsample2x.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stylemc_upsample2x(x.data_ptr(), y.data_ptr(), n * c, h, w,
                                     *taps, stream)
    if err != 0:
        raise RuntimeError(f"upsample2x kernel launch failed: CUDA error {err}")
    upsample2d_kernel.launches += 1
    return y


def upsample2d_kernel(x: torch.Tensor, f) -> torch.Tensor:
    """`upsample2d(x, f)` (up=2, padding 0, gain 1, no flip) for a separable
    4-tap filter `f`, through the CUDA kernel on a CUDA tensor and
    `upsample2d_plain` on a CPU one. Raises for anything else.
    `upsample2d_kernel.launches` counts kernel launches."""
    if not isinstance(x, torch.Tensor) or x.ndim != 4:
        raise ValueError("expected a 4-D NCHW tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f, np.float64)
    taps = _upsample_taps(f.shape, f.tobytes())
    if x.device.type == "cpu":
        return upsample2d_plain(x, taps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.requires_grad:
        raise NotImplementedError(
            "upsample2d_kernel is forward only: its backward, the 2x "
            "downsample kernel (_downsample2x_core), is not ported yet")
    return _launch(x, taps)


upsample2d_kernel.launches = 0
