"""The losses of find_direction: ArcFace identity, the StyleMC CLIP
direction and the StyleGAN-NADA CLIP terms it reads."""

from .clip_loss import make_text_direction, clip_directional_loss
from .clip_loss_nada import (
    NADATextAnchors, preprocess_nada, direction_loss,
    imagenet_templates_small,
    compute_text_direction, get_text_features,
)
from .id_loss import id_loss, extract_feats

__all__ = [
    "make_text_direction", "clip_directional_loss",
    "NADATextAnchors", "preprocess_nada", "direction_loss",
    "imagenet_templates_small",
    "compute_text_direction", "get_text_features",
    "id_loss", "extract_feats",
]
