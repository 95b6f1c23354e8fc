"""The latent-codes discriminator and the W pool (counterpart of
`stylemc_tpu/models/e4e/discriminator.py`).

The discriminator is e4e's 512 → 512 ×4 → 1 MLP with LeakyReLU(0.2) over
single w vectors; params {'fc{i}': {'weight': [out, in], 'bias': [out]}}.
The pool is the image-pool trick over w codes, host-side, drawing from
Python's `random` in the JAX package's order, so a seeded `random` gives
the same codes in both packages.
"""

from __future__ import annotations

import random
from typing import Any, Dict

import numpy as np
import torch

from ...device import DeviceLike, resolve_device


def init_discriminator_params(gen: torch.Generator, style_dim: int = 512,
                              n_mlp: int = 4, device: DeviceLike = None
                              ) -> Dict[str, Any]:
    """Weights U(−1/sqrt(512), 1/sqrt(512)) drawn from `gen`, zero biases."""
    dev = resolve_device(device)
    bound = 1.0 / np.sqrt(style_dim)
    dims = [style_dim] * n_mlp + [1]
    params = {}
    for i in range(n_mlp + 1):
        shape = (dims[i], style_dim if i == 0 else dims[i - 1])
        w = torch.rand(shape, generator=gen, device=gen.device)
        params[f"fc{i}"] = {"weight": (w * (2 * bound) - bound).to(dev),
                            "bias": torch.zeros((dims[i],), device=dev)}
    return params


def discriminator_apply(params, w: torch.Tensor, n_mlp: int = 4
                        ) -> torch.Tensor:
    """w: [N, 512] → logits [N, 1]."""
    x = w
    for i in range(n_mlp + 1):
        p = params[f"fc{i}"]
        x = x @ p["weight"].T.to(x.dtype) + p["bias"].to(x.dtype)
        if i < n_mlp:
            x = torch.where(x >= 0, x, 0.2 * x)
    return x


class LatentCodesPool:
    """Query-replace pool of w codes. `query` takes [N, 512] or
    [N, num_ws, 512] (one row drawn per sample) and returns numpy
    [N, 512]."""

    def __init__(self, pool_size: int):
        self.pool_size = pool_size
        self.num_ws = 0
        self.ws = []

    def query(self, ws):
        if self.pool_size == 0:
            return ws
        if isinstance(ws, torch.Tensor):
            ws = ws.detach().cpu().numpy()
        return_ws = []
        for w in np.asarray(ws):
            if w.ndim == 2:
                w = w[random.randint(0, len(w) - 1)]
            self._handle_w(w, return_ws)
        return np.stack(return_ws, axis=0)

    def _handle_w(self, w, return_ws):
        if self.num_ws < self.pool_size:
            self.num_ws += 1
            self.ws.append(w)
            return_ws.append(w)
        elif random.uniform(0, 1) > 0.5:
            random_id = random.randint(0, self.pool_size - 1)
            tmp = self.ws[random_id].copy()
            self.ws[random_id] = w
            return_ws.append(tmp)
        else:
            return_ws.append(w)
