"""W-norm regulariser (counterpart of `stylemc_tpu/losses/w_norm.py`): the
batch mean of each sample's L2 norm of (latent − latent_avg), taken over
the (style, channel) axes."""

from __future__ import annotations

from typing import Optional

import torch


def w_norm_loss(latent: torch.Tensor, latent_avg: Optional[torch.Tensor] = None,
                start_from_latent_avg: bool = True) -> torch.Tensor:
    """latent: [N, S, 512]; latent_avg: [S, 512] or None."""
    if start_from_latent_avg and latent_avg is not None:
        latent = latent - latent_avg.to(latent.dtype)
    per_sample = torch.sqrt(torch.sum(latent.square(), dim=(1, 2)))
    return torch.sum(per_sample) / latent.shape[0]
