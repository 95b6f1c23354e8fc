"""StyleGAN-NADA CLIP terms that find_direction reads (counterpart of
`stylemc_tpu/losses/clip_loss_nada.py:27-116`): template-averaged text
directions over the 27 imagenet templates, NADA preprocessing, and the
directional loss. The global, angle, texture and patch losses of the JAX
module are not ported yet (ROADMAP A12b)."""

from __future__ import annotations

import dataclasses

import torch

from ..models.clip import encode_image, encode_text, tokenize
from ..models.clip.preprocess import center_crop, clip_mean_std, resize_short_side

imagenet_templates_small = [
    "a photo of a {}.", "a rendering of a {}.", "a cropped photo of the {}.",
    "the photo of a {}.", "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a photo of my {}.", "a photo of the cool {}.",
    "a close-up photo of a {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a photo of the {}.", "a good photo of the {}.",
    "a photo of one {}.", "a close-up photo of the {}.", "a rendition of the {}.",
    "a photo of the clean {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a good photo of a {}.", "a photo of the nice {}.",
    "a photo of the small {}.", "a photo of the weird {}.",
    "a photo of the large {}.", "a photo of a cool {}.",
    "a photo of a small {}.",
]


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def preprocess_nada(img: torch.Tensor, img_size: int = 224) -> torch.Tensor:
    """GAN output [-1,1] → CLIP input (no 0..255 clamp, unlike unprocess)."""
    x = (img + 1.0) / 2.0
    x = resize_short_side(x, img_size)
    x = center_crop(x, img_size)
    mean, std = clip_mean_std(x)
    return (x - mean) / std


def direction_loss(x, y, loss_type: str = "cosine") -> torch.Tensor:
    """NADA's DirectionLoss: cosine, mse or mae."""
    if loss_type == "cosine":
        cos = torch.sum(x * y, dim=-1) / (
            torch.linalg.vector_norm(x, dim=-1)
            * torch.linalg.vector_norm(y, dim=-1))
        return torch.mean(1.0 - cos)
    if loss_type == "mse":
        return torch.mean(torch.square(x - y))
    if loss_type == "mae":
        return torch.mean(torch.abs(x - y))
    raise ValueError(loss_type)


def compose_text_with_templates(text: str, templates=imagenet_templates_small):
    return [t.format(text) for t in templates]


def get_text_features(clip_params, clip_cfg, class_str: str, tokenizer=None,
                      templates=imagenet_templates_small, norm: bool = True
                      ) -> torch.Tensor:
    tokens = tokenize(compose_text_with_templates(class_str, templates),
                      tokenizer=tokenizer)
    f = encode_text(clip_params, clip_cfg, tokens)
    return _normalize(f) if norm else f


def compute_text_direction(clip_params, clip_cfg, source_class: str,
                           target_class: str, tokenizer=None) -> torch.Tensor:
    src = get_text_features(clip_params, clip_cfg, source_class, tokenizer)
    tgt = get_text_features(clip_params, clip_cfg, target_class, tokenizer)
    return _normalize(torch.mean(tgt - src, dim=0, keepdim=True))


@dataclasses.dataclass
class NADATextAnchors:
    """Precomputed text features for one (source_class, target_class) pair."""
    target_direction: torch.Tensor           # [1, D]
    src_text_features: torch.Tensor          # [1, D]
    target_text_features: torch.Tensor       # [1, D]
    global_tokens: torch.Tensor              # [1, 77] for "a {target_class}"

    @classmethod
    def create(cls, clip_params, clip_cfg, source_class: str,
               target_class: str, tokenizer=None) -> "NADATextAnchors":
        src = get_text_features(clip_params, clip_cfg, source_class, tokenizer)
        tgt = get_text_features(clip_params, clip_cfg, target_class, tokenizer)
        tokens = tokenize([f"a {target_class}"], tokenizer=tokenizer)
        return cls(
            target_direction=_normalize(torch.mean(tgt - src, dim=0,
                                                   keepdim=True)),
            src_text_features=_normalize(src.mean(dim=0, keepdim=True)),
            target_text_features=_normalize(tgt.mean(dim=0, keepdim=True)),
            global_tokens=torch.as_tensor(tokens, dtype=torch.long,
                                          device=src.device),
        )

