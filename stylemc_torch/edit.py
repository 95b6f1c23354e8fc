"""S-space edit application (counterpart of `stylemc_tpu/edit.py`): render
[original | edited] where edited styles = styles + direction · change_power.

The direction is a saved global direction or, per item, a latent mapper's
(`mapper_direction`, `mapper_directions_batched`; with use_whitelist,
|δ| < 0.1 is set to 0 and the stoplist's S-space ids are zeroed). With
DeepLab feature blending (`apply_edit_item_with_blending`) the edited image
is rendered again with its features blended toward the original's under
the earring (32²), background and teeth (64²) masks; the masks are resized
on the host (cv2 INTER_AREA) and fed to `synthesis`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.mapper import mapper_apply
from .models.stylegan2.generator import (GeneratorConfig, N_STYLE_CHANNELS,
                                         S_TRAINABLE_SPACE_CHANNELS,
                                         STYLE_DIM, synthesis)

__all__ = ["N_STYLE_CHANNELS", "STYLE_DIM", "WHITELIST_S_IDS",
           "STOPLIST_S_IDS", "TRAINABLE", "to_u8_nhwc", "to_uint8_hwc",
           "mapper_direction", "mapper_directions_batched",
           "resize_mask_area", "apply_edit_batch",
           "apply_edit_item_with_blending"]

# flat ids into the [26 · 512] S space (the reference's generate_fromS)
WHITELIST_S_IDS = [3405, 5886, 1713, 4934, 4845, 3216, 3583, 4878, 6605, 5711,
                   6487, 4223, 3264, 3122, 5644, 5700, 4595, 4821, 4815, 6289,
                   6388, 4844, 4838, 4982, 5822, 6301, 3447, 1827, 5836, 3203,
                   6264, 4866, 6047, 1718, 4842, 5807, 3262, 4750, 6129, 4353,
                   6293, 3134, 4752, 3352, 3116, 5748, 5091, 3266, 6326, 6504,
                   3103, 1917, 3359, 3176, 3349, 4848, 6461, 3267, 1968, 3153,
                   3351, 5673, 4351, 6452, 4676]
STOPLIST_S_IDS = [4863, 6247, 4943, 4724, 3114, 4623, 4726]

TRAINABLE = list(S_TRAINABLE_SPACE_CHANNELS)


def to_u8_nhwc(img: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] in [-1, 1] → uint8 [N, H, W, 3] on the same device:
    img·127.5 + 128, clipped to [0, 255], truncated toward zero."""
    return torch.clamp(img.permute(0, 2, 3, 1) * 127.5 + 128, 0, 255
                       ).to(torch.uint8)


def to_uint8_hwc(img: torch.Tensor) -> np.ndarray:
    """`to_u8_nhwc`, fetched to the host as a numpy array."""
    return to_u8_nhwc(img).cpu().numpy()


@torch.no_grad()
def mapper_directions_batched(mapper, styles: torch.Tensor,
                              neg_slope: float = 0.01,
                              use_whitelist: bool = False) -> torch.Tensor:
    """Per-item mapper directions: styles [N, 26, 512] → directions
    [N, 26, 512] (zero outside the trainable rows), in one mapper call."""
    delta = mapper_apply(mapper, styles[:, TRAINABLE], neg_slope)
    if use_whitelist:
        delta = torch.where(delta.abs() < 0.1, torch.zeros_like(delta), delta)
    rows = torch.tensor(TRAINABLE, device=styles.device)
    directions = delta.new_zeros((styles.shape[0], N_STYLE_CHANNELS,
                                  STYLE_DIM)).index_copy(1, rows, delta)
    if use_whitelist:
        stop = torch.tensor(STOPLIST_S_IDS, device=styles.device)
        directions = directions.reshape(styles.shape[0], -1).index_fill(
            1, stop, 0.0).reshape(directions.shape)
    return directions


def mapper_direction(mapper, styles_item: torch.Tensor,
                     neg_slope: float = 0.01, use_whitelist: bool = False
                     ) -> torch.Tensor:
    """One item's mapper direction: styles_item [26, 512] → [1, 26, 512]."""
    return mapper_directions_batched(mapper, styles_item[None], neg_slope,
                                     use_whitelist)


def resize_mask_area(mask: np.ndarray, res: int) -> np.ndarray:
    """A blending mask resized to res × res with cv2's INTER_AREA (float64),
    as the reference resizes it."""
    import cv2

    return cv2.resize(mask.astype("float"), (res, res),
                      interpolation=cv2.INTER_AREA)


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


@torch.inference_mode()
def apply_edit_item_with_blending(gen_params, gen_cfg: GeneratorConfig,
                                  styles_item: torch.Tensor,
                                  direction: torch.Tensor,
                                  change_power: float, segmenter,
                                  text_prompt: str = "",
                                  noise_mode: str = "const",
                                  gen2: Optional[Tuple] = None):
    """One item with DeepLab feature blending, the reference's flow: render
    the original (keeping its per-block features) and the edit; take the
    background mask of the original and the earring, mouth and teeth masks
    of the edit; render the edit again, its 32² features blended toward the
    original's under the earring mask and its 64² features under the
    background and teeth masks. `segmenter` provides get_bg_mask(img_u8)
    and get_earring_mouth_teeth_masks(img_u8, need_earring_mask) on uint8
    HWC images. No earring mask when the prompt contains 'face of a man'.

    Returns (orig_u8, edited_u8), uint8 HWC."""
    e_params, e_cfg = gen2 if gen2 is not None else (gen_params, gen_cfg)
    s = styles_item[None]
    dev = s.device

    xs_original, img0 = synthesis(gen_params, gen_cfg, s,
                                  noise_mode=noise_mode, return_features=True)
    orig_u8 = to_uint8_hwc(img0)[0]
    bg_mask = segmenter.get_bg_mask(orig_u8)

    s2 = s + direction * change_power
    img1 = synthesis(e_params, e_cfg, s2, noise_mode=noise_mode)
    earring_mask, _, teeth_mask = segmenter.get_earring_mouth_teeth_masks(
        to_uint8_hwc(img1)[0],
        need_earring_mask="face of a man" not in text_prompt)

    def on_device(mask, res):
        return torch.from_numpy(resize_mask_area(mask, res)).to(
            device=dev, dtype=torch.float32)[None, None]

    blend_masks: Dict[int, List[torch.Tensor]] = {}
    if earring_mask is not None:
        blend_masks[32] = [on_device(earring_mask, 32)]
    masks64 = [on_device(m, 64) for m in (bg_mask, teeth_mask)
               if m is not None]
    if masks64:
        blend_masks[64] = masks64

    img1b = synthesis(e_params, e_cfg, s2, noise_mode=noise_mode,
                      blend_masks=blend_masks, xs_original=xs_original)
    return orig_u8, to_uint8_hwc(img1b)[0]
