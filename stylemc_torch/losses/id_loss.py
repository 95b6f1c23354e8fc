"""ArcFace identity loss (counterpart of `stylemc_tpu/losses/id_loss.py`):
adaptive-pool to 256² if needed, crop rows 35:223 / cols 32:220,
adaptive-pool to 112², IR-SE embed; loss = mean(1 − ⟨f(edited),
f(original)⟩) with the original's features detached."""

from __future__ import annotations

import torch

from ..models.arcface import backbone_apply
from ..utils.image import adaptive_avg_pool2d


def extract_feats(arcface_params, x: torch.Tensor, layout=None
                  ) -> torch.Tensor:
    """x: [N,3,H,W] in [-1,1] → L2-normalized [N,512]."""
    if x.shape[2] != 256:
        x = adaptive_avg_pool2d(x, 256, 256)
    x = x[:, :, 35:223, 32:220]
    x = adaptive_avg_pool2d(x, 112, 112)
    return backbone_apply(arcface_params, x, layout=layout)


def id_loss(arcface_params, y_hat: torch.Tensor, y: torch.Tensor,
            layout=None) -> torch.Tensor:
    """y_hat: edited image, y: original (its features detached)."""
    f_y = extract_feats(arcface_params, y, layout).detach()
    f_hat = extract_feats(arcface_params, y_hat, layout)
    return torch.mean(1.0 - torch.sum(f_hat * f_y, dim=1))
