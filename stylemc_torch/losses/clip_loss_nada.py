"""StyleGAN-NADA CLIP losses (counterpart of
`stylemc_tpu/losses/clip_loss_nada.py`): template-averaged text directions
over the 27 imagenet templates, NADA preprocessing, the directional,
global, angle (manifold), texture (an RN50 embedding MSE) and patch
losses, and their weighted sum `nada_loss`. Patch centres come from the
caller, on the host, as in the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
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



def _image_features(clip_params, clip_cfg, img):
    return _normalize(encode_image(
        clip_params, clip_cfg, preprocess_nada(img, clip_cfg.image_resolution)))


def clip_directional_loss_nada(clip_params, clip_cfg, src_img, target_img,
                               anchors: NADATextAnchors,
                               direction_loss_type: str = "cosine"):
    src = _image_features(clip_params, clip_cfg, src_img)
    tgt = _image_features(clip_params, clip_cfg, target_img)
    edit = tgt - src
    edit = edit / torch.clamp(torch.linalg.vector_norm(edit, dim=-1,
                                                       keepdim=True), min=1e-6)
    return direction_loss(edit, anchors.target_direction.to(edit.dtype),
                          direction_loss_type)


def global_clip_loss(clip_params, clip_cfg, img, anchors: NADATextAnchors):
    """(1 − logits/100).mean() over logit_scale-weighted image-text
    logits."""
    image_f = _image_features(clip_params, clip_cfg, img)
    text_f = _normalize(encode_text(clip_params, clip_cfg,
                                    anchors.global_tokens))
    logits = torch.exp(clip_params["logit_scale"]) * image_f @ text_f.T
    return torch.mean(1.0 - logits / 100.0)


def clip_angle_loss(clip_params, clip_cfg, src_img, target_img,
                    anchors: NADATextAnchors):
    cos_text = anchors.target_text_features @ anchors.src_text_features.T
    src = _image_features(clip_params, clip_cfg, src_img)[:, :, None]
    tgt = _image_features(clip_params, clip_cfg, target_img)[:, None, :]
    cos_img = torch.clamp(tgt @ src, -1.0, 1.0)
    return torch.mean(torch.abs(cos_img - cos_text[None].expand_as(cos_img)))


def cnn_feature_loss(rn_params, rn_cfg, src_img, target_img):
    """The texture loss: MSE between RN50 embeddings."""
    f_src = encode_image(rn_params, rn_cfg,
                         preprocess_nada(src_img, rn_cfg.image_resolution))
    f_tgt = encode_image(rn_params, rn_cfg,
                         preprocess_nada(target_img, rn_cfg.image_resolution))
    return torch.mean(torch.square(f_src - f_tgt))


def nada_loss(clip_params, clip_cfg, src_img, target_img,
              anchors: NADATextAnchors,
              lambda_direction: float = 1.0, lambda_global: float = 0.0,
              lambda_manifold: float = 0.0,
              rn_params=None, rn_cfg=None, texture_image=None,
              lambda_texture: float = 0.0,
              direction_loss_type: str = "cosine"):
    """The composite NADA loss. The patch loss is separate
    (`patch_directional_loss`): its centres come from the host."""
    loss = 0.0
    if lambda_global:
        loss += lambda_global * global_clip_loss(clip_params, clip_cfg,
                                                 target_img, anchors)
    if lambda_direction:
        loss += lambda_direction * clip_directional_loss_nada(
            clip_params, clip_cfg, src_img, target_img, anchors,
            direction_loss_type)
    if lambda_manifold:
        loss += lambda_manifold * clip_angle_loss(clip_params, clip_cfg,
                                                  src_img, target_img, anchors)
    if lambda_texture and texture_image is not None and rn_params is not None:
        loss += lambda_texture * cnn_feature_loss(rn_params, rn_cfg,
                                                  texture_image, target_img)
    return loss


def generate_patches(img, patch_centers, size: int):
    """[N·P, C, size, size] patches around patch_centers [N·P, 2] (x, y)
    ints. Each window's start is read as `jax.lax.dynamic_slice` reads it:
    a negative start counts from the end of its axis, and the window is
    then clamped into the image."""
    n, _, h, w = img.shape
    centers = np.asarray(torch.as_tensor(patch_centers).cpu(), np.int64)
    num_patches = centers.shape[0] // n
    half = size // 2

    def start(s, dim):
        s = s + dim if s < 0 else s
        return min(max(s, 0), dim - size)

    patches = []
    for b in range(n):
        for p in range(num_patches):
            cx, cy = centers[b * num_patches + p]
            y0, x0 = start(int(cy) - half, h), start(int(cx) - half, w)
            patches.append(img[b, :, y0:y0 + size, x0:x0 + size])
    return torch.stack(patches, dim=0)


def patch_directional_loss(clip_params, clip_cfg, src_img, target_img,
                           patch_text_directions, patch_centers,
                           patch_size: int = 510):
    src_p = generate_patches(src_img, patch_centers, patch_size)
    tgt_p = generate_patches(target_img, patch_centers, patch_size)
    edit = _normalize(_image_features(clip_params, clip_cfg, tgt_p)
                      - _image_features(clip_params, clip_cfg, src_p))
    ptd = patch_text_directions.to(edit.dtype)
    cosine_dists = 1.0 - (edit[:, None, :] * ptd[None, :, :]).sum(-1)
    scores = cosine_dists * torch.softmax(edit @ ptd.T, dim=-1)
    return torch.mean(scores)
