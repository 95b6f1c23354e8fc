"""Carry parameter trees between the JAX package's numpy layout and torch.

A tree is the nested dict of `stylemc_tpu`'s params: the generator's
(`mapping.fc{i}.{weight,bias}`, `mapping.w_avg`,
`synthesis.b{res}.{const,conv0,conv1,torgb}...`), ArcFace's, CLIP's, the
e4e encoders', MobileNet-GDConv's (`stem`, `blocks.{i}`, `head`,
`linear7`, `linear1`) and each MTCNN net's flat dict keyed by the torch
parameter names (`features.conv1.weight`, ...). The port keeps every
layout with torch tensors as leaves, so a parameter has the same path in
both, and these two functions carry any of them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """Nested dict of arrays (numpy, anything `np.asarray` takes, or torch
    tensors) → the same nested dict of float32 torch tensors on `device`."""
    dev = resolve_device(device)

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to(device=dev, dtype=torch.float32).contiguous()
        arr = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
        return torch.from_numpy(arr.copy()).to(dev)

    return {k: params_from_numpy(v, dev) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items() if v is not None}


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params → nested dict of float32 numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().astype(np.float32)
            for k, v in params.items()}


def as_float32(v, device) -> torch.Tensor:
    """A tensor or anything `np.asarray` takes → a float32 tensor on
    `device` (arrays are copied, so read-only ones are fine)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
