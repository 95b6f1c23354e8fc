"""Differentiable CLIP image preprocessing (counterpart of
`stylemc_tpu/models/clip/preprocess.py`).

Generator output in [-1, 1] → (x·127.5 + 128).clamp(0, 255) → Resize(224,
bicubic) + CenterCrop(224) → /255 → CLIP normalize. The bicubic resize is
two dense matrix products (out = Ky @ img @ Kxᵀ) with the JAX package's
matrices, not `F.interpolate`, so the numbers match.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.profiling import to_device
from .model import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def _cubic_kernel(x, a=-0.75):
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2, a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a, 0.0))


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] bicubic interpolation matrix (edge-clamped),
    matching torch interpolate(align_corners=False, antialias=False)."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - 2.0)) + 1
        hi = int(np.floor(center + 2.0)) + 1
        idx = np.arange(lo, hi)
        w = _cubic_kernel(idx - center)
        w = w / w.sum()
        idx = np.clip(idx, 0, in_size - 1)
        for j, wi in zip(idx, w):
            mat[i, j] += wi
    return mat.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """x: [..., H, W] → [..., out_h, out_w] via two dense matrix products."""
    h, w = x.shape[-2], x.shape[-1]

    def mat(n_in, n_out):
        return to_device(_resize_matrix(n_in, n_out), x.device, x.dtype)

    x = torch.matmul(mat(h, out_h), x)
    return torch.matmul(x, mat(w, out_w).T)


def resize_short_side(x: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision Resize(size) semantics: scale so the short side == size."""
    h, w = x.shape[-2], x.shape[-1]
    if h <= w:
        out_h, out_w = size, max(1, int(round(w * size / h)))
    else:
        out_h, out_w = max(1, int(round(h * size / w))), size
    return resize_bicubic(x, out_h, out_w)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    top = (h - size) // 2
    left = (w - size) // 2
    return x[..., top:top + size, left:left + size]


def clip_mean_std(like: torch.Tensor):
    """CLIP's mean and std as [3, 1, 1] tensors of `like`'s dtype/device."""
    return (to_device(CLIP_IMAGE_MEAN, like.device, like.dtype).reshape(
                3, 1, 1),
            to_device(CLIP_IMAGE_STD, like.device, like.dtype).reshape(
                3, 1, 1))


def unprocess(img: torch.Tensor, img_size: int = 224) -> torch.Tensor:
    """Generator output [N,3,H,W] in [-1,1] → CLIP input [N,3,224,224]:
    ·127.5 + 128, clamp(0, 255), resize + crop, /255, normalize."""
    x = torch.clamp(img * 127.5 + 128.0, 0.0, 255.0)
    x = resize_short_side(x, img_size)
    x = center_crop(x, img_size)
    mean, std = clip_mean_std(x)
    return (x / 255.0 - mean) / std
