"""MoCo-v2 feature similarity loss and e4e's three-way identity loss
(counterpart of `stylemc_tpu/losses/moco.py`).

loss = mean(1 − ⟨f(ŷ), f(y)⟩) with f(y) detached; beside it the
similarity improvement mean(⟨f(ŷ), f(y)⟩ − ⟨f(y), f(x)⟩). MoCo's f is
ResNet-50's pooled features, L2-normalised, at 224² (a bicubic matrix
resize); e4e's identity f is ArcFace's crop and embedding.
"""

from __future__ import annotations

import torch

from ..models.clip.preprocess import resize_bicubic
from ..models.resnet import resnet50_features
from .id_loss import extract_feats


def moco_extract_feats(params, x: torch.Tensor) -> torch.Tensor:
    if x.shape[-1] != 224:
        x = resize_bicubic(x, 224, 224)
    f = resnet50_features(params, x)
    return f / torch.linalg.vector_norm(f, dim=1, keepdim=True)


def _three_way(f_x, f_y, f_hat):
    diff_target = torch.sum(f_hat * f_y, dim=1)
    diff_views = torch.sum(f_y * f_x, dim=1)
    return (torch.mean(1.0 - diff_target),
            torch.mean(diff_target - diff_views))


def moco_loss(params, y_hat, y, x):
    """→ (loss, similarity improvement)."""
    f_x = moco_extract_feats(params, x)
    f_y = moco_extract_feats(params, y).detach()
    return _three_way(f_x, f_y, moco_extract_feats(params, y_hat))


def e4e_id_loss(arcface_params, y_hat, y, x, layout=None):
    """e4e's ArcFace identity loss: the same crop as `id_loss`, and the
    similarity improvement beside it. → (loss, similarity improvement)."""
    f_x = extract_feats(arcface_params, x, layout)
    f_y = extract_feats(arcface_params, y, layout).detach()
    return _three_way(f_x, f_y, extract_feats(arcface_params, y_hat, layout))
