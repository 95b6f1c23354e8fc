"""LPIPS perceptual loss (counterpart of `stylemc_tpu/losses/lpips.py`):
squared differences of the backbone's unit-normalised taps, weighted per
channel by the 1x1 "lin" convs, averaged over space, summed over taps and
averaged over the batch."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.perceptual import (backbone_from_torch_state, features,
                                 init_backbone, lpips_channels)


def lpips_distances(lpips_params, x, y, net_type: str = "alex"):
    """x, y: [N, 3, H, W] in [-1, 1] → the per-pair LPIPS distance [N]."""
    bp = lpips_params["backbone"]
    lins = lpips_params["lin"]
    fx = features(bp, x, net_type)
    fy = features(bp, y, net_type)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (a - b).square()
        w = lins[f"{i}"]["weight"].to(d.dtype)[0, :, 0, 0]  # [C]
        total = total + torch.einsum("nchw,c->nhw", d, w).mean(dim=(1, 2))
    return total


def lpips_loss(lpips_params, x, y, net_type: str = "alex"):
    """x, y: [N, 3, H, W] in [-1, 1] → scalar LPIPS."""
    return lpips_distances(lpips_params, x, y, net_type).sum() / x.shape[0]


def init_lpips_params(gen: torch.Generator, net_type: str = "alex",
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded backbone and U(0, 1) lin weights, drawn from `gen`."""
    dev = resolve_device(device)
    backbone = init_backbone(gen, net_type, dev)
    lins = {f"{i}": {"weight": torch.rand((1, c, 1, 1), generator=gen,
                                          device=gen.device).to(dev)}
            for i, c in enumerate(lpips_channels(net_type))}
    return {"backbone": backbone, "lin": lins}


def lpips_params_from_torch(backbone_state: Dict[str, np.ndarray],
                            lin_state: Dict[str, np.ndarray],
                            net_type: str = "alex") -> Dict[str, Any]:
    """backbone_state: torchvision `features.*` names; lin_state: the
    richzhang lin weights after the reference's key renaming
    ('{i}.1.weight', or '{i}.weight') → the params tree of numpy arrays."""
    lins = {}
    for i in range(len(lpips_channels(net_type))):
        key = f"{i}.1.weight" if f"{i}.1.weight" in lin_state else f"{i}.weight"
        lins[f"{i}"] = {"weight": lin_state[key]}
    return {"backbone": backbone_from_torch_state(backbone_state, net_type),
            "lin": lins}
