"""StyleMC CLIP loss, the default `clip_loss_type` (counterpart of
`stylemc_tpu/losses/clip_loss.py`): the text direction is E_T(prompt) −
E_T(negative prompt), normalized once; per step the image direction
E_I(edited) − E_I(source) is normalized and the loss is the mean of
(1 − cosine similarity) against the text direction."""

from __future__ import annotations

import torch

from ..models.clip import encode_image, encode_text


def _norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=True)


def make_text_direction(clip_params, clip_cfg, tokens_pos, tokens_neg
                        ) -> torch.Tensor:
    """→ normalized [1, embed_dim] text direction."""
    d = encode_text(clip_params, clip_cfg, tokens_pos) - \
        encode_text(clip_params, clip_cfg, tokens_neg)
    return d / _norm(d, 1)


def clip_directional_loss(clip_params, clip_cfg, src_image, tgt_image,
                          text_direction) -> torch.Tensor:
    """src/tgt_image: CLIP-preprocessed [N,3,224,224]. → scalar loss."""
    d = encode_image(clip_params, clip_cfg, tgt_image) - \
        encode_image(clip_params, clip_cfg, src_image)
    # norm clamped: identical images give loss 1 with finite grads, not NaN
    d = d / torch.clamp(_norm(d, 1), min=1e-6)
    cos = torch.sum(d * text_direction.to(d.dtype), dim=1) / \
        torch.linalg.vector_norm(text_direction, dim=1)
    return torch.mean(1.0 - cos)
