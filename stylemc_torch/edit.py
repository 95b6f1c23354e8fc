"""S-space edit application (counterpart of `stylemc_tpu/edit.py`): render
[original | edited] where edited styles = styles + direction · change_power.

Mapper directions and DeepLab feature blending are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .models.stylegan2.generator import (GeneratorConfig, N_STYLE_CHANNELS,
                                         STYLE_DIM, synthesis)

__all__ = ["N_STYLE_CHANNELS", "STYLE_DIM", "to_u8_nhwc", "to_uint8_hwc",
           "apply_edit_batch"]


def to_u8_nhwc(img: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] in [-1, 1] → uint8 [N, H, W, 3] on the same device:
    img·127.5 + 128, clipped to [0, 255], truncated toward zero."""
    return torch.clamp(img.permute(0, 2, 3, 1) * 127.5 + 128, 0, 255
                       ).to(torch.uint8)


def to_uint8_hwc(img: torch.Tensor) -> np.ndarray:
    """`to_u8_nhwc`, fetched to the host as a numpy array."""
    return to_u8_nhwc(img).cpu().numpy()


@torch.inference_mode()
def apply_edit_batch(gen_params, gen_cfg: GeneratorConfig, styles, direction,
                     change_power: float, noise_mode: str = "const",
                     gen2: Optional[Tuple] = None):
    """Batched [original | edited] rendering.

    styles: [N, 26, 512]; direction: [N or 1, 26, 512]; gen2: optional
    (params, cfg) of a second generator that renders the edited image.
    Returns (orig_imgs, edited_imgs), float [-1, 1] NCHW."""
    e_params, e_cfg = gen2 if gen2 is not None else (gen_params, gen_cfg)
    orig = synthesis(gen_params, gen_cfg, styles, noise_mode=noise_mode)
    edited = synthesis(e_params, e_cfg, styles + direction * change_power,
                       noise_mode=noise_mode)
    return orig, edited
