"""Differentiable image resizing shared by the loss stack (counterpart of
`stylemc_tpu/utils/image.py`): adaptive average pooling as two dense
matrix products, so the numbers match the JAX package's."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .profiling import to_device


@functools.lru_cache(maxsize=64)
def adaptive_avg_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out, in] matrix reproducing torch AdaptiveAvgPool semantics:
    output[i] = mean(input[floor(i*in/out) : ceil((i+1)*in/out)])."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)  # ceil
        mat[i, lo:hi] = 1.0 / (hi - lo)
    return mat


def _matrix(in_size: int, out_size: int, like: torch.Tensor) -> torch.Tensor:
    return to_device(adaptive_avg_pool_matrix(in_size, out_size),
                     like.device, like.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """x: [..., H, W] → [..., out_h, out_w], AdaptiveAvgPool2d semantics,
    as two dense matrix products (differentiable)."""
    h, w = x.shape[-2], x.shape[-1]
    if h == out_h and w == out_w:
        return x
    x = torch.matmul(_matrix(h, out_h, x), x)
    return torch.matmul(x, _matrix(w, out_w, x).T)
