"""Pad → zero-upsample → FIR filter → downsample for batched NCHW images.

Counterpart of `stylemc_tpu/ops/upfirdn2d.py`, with the same semantics: a
zero-insertion plus edge pad (negative pads crop), then a valid-mode FIR
correlation whose stride carries the downsample. Separable filters run as
two rank-1 convolutions. Plain torch ops, differentiable to any order.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import to_device

_IntOrPair = Union[int, Sequence[int]]


def _parse_scaling(scaling: _IntOrPair):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert isinstance(sx, int) and isinstance(sy, int)
    assert sx >= 1 and sy >= 1
    return sx, sy


def _parse_padding(padding: _IntOrPair):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    assert all(isinstance(p, int) for p in padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _get_filter_size(f) -> tuple:
    if f is None:
        return 1, 1
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])


def filter_like(f, x: torch.Tensor) -> torch.Tensor:
    """A filter (numpy array or tensor) as a float32 tensor on x's device."""
    return to_device(np.asarray(f) if not isinstance(f, torch.Tensor) else f,
                     x.device, torch.float32)


def setup_filter_np(f, normalize=True, flip_filter=False, gain=1,
                    separable=None) -> np.ndarray:
    """Prepare a 2D FIR filter as float32 numpy: [fh, fw], or [taps] when
    separable (defaults to separable for 1-D filters of 8 taps or more)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[tuple(slice(None, None, -1) for _ in range(f.ndim))]
    f = f * (gain ** (f.ndim / 2))
    return f.astype(np.float32)


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None,
                 device="cpu") -> torch.Tensor:
    """`setup_filter_np` as a float32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(setup_filter_np(
        f, normalize, flip_filter, gain, separable))).to(device)


def _pad_dilate(x, up, padding):
    """Zero-upsample by `up` (up-1 zeros after every sample, the last one
    included), then pad or crop the edges."""
    upx, upy = up
    px0, px1, py0, py1 = padding
    if upx > 1 or upy > 1:
        n, c, h, w = x.shape
        x = F.pad(x.reshape(n, c, h, 1, w, 1),
                  (0, upx - 1, 0, 0, 0, upy - 1))
        x = x.reshape(n, c, h * upy, w * upx)
    if px0 or px1 or py0 or py1:
        x = F.pad(x, (px0, px1, py0, py1))
    return x


def _fir(x, f, down, flip_filter, gain):
    """Valid-mode FIR filtering with stride `down`; channels fold into the
    batch so the convolution is single-channel."""
    downx, downy = down
    n, c, h, w = x.shape
    f = torch.ones((1, 1), device=x.device) if f is None else filter_like(f, x)
    f = (f * (gain ** (f.ndim / 2))).to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    xr = x.reshape(n * c, 1, h, w)
    if f.ndim == 1:
        xr = F.conv2d(xr, f.reshape(1, 1, -1, 1), stride=(downy, 1))
        xr = F.conv2d(xr, f.reshape(1, 1, 1, -1), stride=(1, downx))
    else:
        xr = F.conv2d(xr, f[None, None], stride=(downy, downx))
    return xr.reshape(n, c, xr.shape[2], xr.shape[3])


def upfirdn2d(x, f, up: _IntOrPair = 1, down: _IntOrPair = 1,
              padding: _IntOrPair = 0, flip_filter=False, gain=1):
    """Zero-upsample by `up`, pad (negative = crop), convolve with `f`
    (flip_filter=True → correlation), keep every `down`-th pixel."""
    assert x.ndim == 4, f"expected NCHW, got shape {tuple(x.shape)}"
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    pads = _parse_padding(padding)
    x = _pad_dilate(x, (upx, upy), pads)
    return _fir(x, f, (downx, downy), flip_filter, gain)


def filter2d(x, f, padding: _IntOrPair = 0, flip_filter=False, gain=1):
    """Filter with an FIR filter, keeping the resolution."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up: _IntOrPair = 2, padding: _IntOrPair = 0,
               flip_filter=False, gain=1):
    """Upsample by `up` with FIR smoothing."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down: _IntOrPair = 2, padding: _IntOrPair = 0,
                 flip_filter=False, gain=1):
    """Downsample by `down` with FIR anti-aliasing."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
