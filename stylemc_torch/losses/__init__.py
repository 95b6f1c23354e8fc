"""The losses: ArcFace identity, the StyleMC CLIP direction and the
StyleGAN-NADA CLIP terms (the landmarks loss and LPIPS are in
`landmarks_loss.py` and `lpips.py`: exporting the function
`landmarks_loss` here would hide the module of that name)."""

from .clip_loss import make_text_direction, clip_directional_loss
from .clip_loss_nada import (
    NADATextAnchors, nada_loss, preprocess_nada, direction_loss,
    clip_directional_loss_nada, global_clip_loss, clip_angle_loss,
    cnn_feature_loss, imagenet_templates_small, compute_text_direction,
    get_text_features,
)
from .id_loss import id_loss, extract_feats

__all__ = [
    "make_text_direction", "clip_directional_loss",
    "NADATextAnchors", "nada_loss", "preprocess_nada", "direction_loss",
    "clip_directional_loss_nada", "global_clip_loss", "clip_angle_loss",
    "cnn_feature_loss", "imagenet_templates_small", "compute_text_direction",
    "get_text_features",
    "id_loss", "extract_feats",
]
