from .model import (
    CLIPConfig, CLIP_CONFIGS, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,
    init_clip_params, encode_image, encode_text,
    params_from_torch_state, config_from_torch_state,
)
from .tokenizer import tokenize, SimpleTokenizer, FallbackTokenizer
from .preprocess import unprocess, resize_bicubic, resize_short_side, center_crop

__all__ = [
    "CLIPConfig", "CLIP_CONFIGS", "CLIP_IMAGE_MEAN", "CLIP_IMAGE_STD",
    "init_clip_params", "encode_image", "encode_text",
    "params_from_torch_state", "config_from_torch_state",
    "tokenize", "SimpleTokenizer", "FallbackTokenizer",
    "unprocess", "resize_bicubic", "resize_short_side", "center_crop",
]
