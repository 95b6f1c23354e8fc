"""S-space edit application (counterpart of `stylemc_tpu/edit.py`): render
[original | edited] where edited styles = styles + direction · change_power.

The direction is a saved global direction or, per item, a latent mapper's
(`mapper_direction`, `mapper_directions_batched`; with use_whitelist,
|δ| < 0.1 is set to 0 and the stoplist's S-space ids are zeroed). With
DeepLab feature blending (`blend_edits`, for a batch; its one-row case
`apply_edit_item_with_blending`) the edited images are rendered again with
their features blended toward the originals' under the earring (32²),
background and teeth (64²) masks; the masks are resized on the host (cv2
INTER_AREA) and fed to `synthesis`, one mask per row.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import host_later
from .models.deeplab import BLEND_MASKS
from .models.mapper import mapper_apply
from .models.stylegan2.generator import (GeneratorConfig, N_STYLE_CHANNELS,
                                         S_TRAINABLE_SPACE_CHANNELS,
                                         STYLE_DIM, synthesis)
from .utils.profiling import record_function, to_device

__all__ = ["N_STYLE_CHANNELS", "STYLE_DIM", "WHITELIST_S_IDS",
           "STOPLIST_S_IDS", "TRAINABLE", "to_u8_nhwc", "to_uint8_hwc",
           "mapper_direction", "mapper_directions_batched",
           "resize_mask_area", "apply_edit_batch", "masks_of",
           "needs_earring_mask", "blend_edits",
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


def masks_of(segmenter, originals_u8: Callable[[], np.ndarray],
             edits_u8: Callable[[], np.ndarray],
             need_earring: Sequence[bool]) -> Dict[str, Optional[np.ndarray]]:
    """The blend masks of N rows, as `Segmenter.blend_masks` gives them,
    from functions that return the uint8 NHWC renders (`host_later`): the
    segmenter's own batched call, or for one that parses an image at a
    time (get_bg_mask(img_u8), get_earring_mouth_teeth_masks(img_u8,
    need_earring_mask)) its calls row by row."""
    if hasattr(segmenter, "blend_masks"):
        return segmenter.blend_masks(originals_u8, edits_u8, need_earring)
    bg, earring, teeth = [], [], []
    for orig, edit, need in zip(originals_u8(), edits_u8(), need_earring):
        bg.append(segmenter.get_bg_mask(orig))
        e, _, t = segmenter.get_earring_mouth_teeth_masks(
            edit, need_earring_mask=need)
        earring.append(np.zeros(t.shape, bool) if e is None else e)
        teeth.append(t)
    return {"background": np.stack(bg), "teeth": np.stack(teeth),
            "earring": np.stack(earring) if any(need_earring) else None}


def _masks_on_device(masks: Dict[str, Optional[np.ndarray]], device
                     ) -> Dict[int, List[torch.Tensor]]:
    """`synthesis`'s blend_masks from N rows of 512² masks: each resized
    on the host with INTER_AREA to its blend resolution, one mask per row
    [N, 1, res, res], all copied to the device in one copy."""
    plan = [(kind, res) for kind, res in BLEND_MASKS
            if masks.get(kind) is not None]
    host = [np.stack([resize_mask_area(m, res) for m in masks[kind]])
            for kind, res in plan]
    flat = to_device(np.concatenate([h.ravel() for h in host]).astype(
        np.float32), device)
    out: Dict[int, List[torch.Tensor]] = {}
    at = 0
    for (_, res), h in zip(plan, host):
        out.setdefault(res, []).append(
            flat[at:at + h.size].view(h.shape[0], 1, res, res))
        at += h.size
    return out


def needs_earring_mask(text_prompt: str) -> bool:
    """The reference's rule: no earring mask for a prompt that asks for
    the face of a man."""
    return "face of a man" not in text_prompt


@torch.inference_mode()
def blend_edits(gen_params, gen_cfg: GeneratorConfig, styles: torch.Tensor,
                edited: torch.Tensor, segmenter,
                need_earring: Sequence[bool], noise_mode: str = "const",
                gen2: Optional[Tuple] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edits of N rows with DeepLab feature blending, the reference's flow
    over a batch: render the originals (keeping their 32² and 64²
    features) and the edits; take the background masks of the originals
    and the earring and teeth masks of the edits (one network call for
    each batch, `masks_of`); render the edits again, their 32² features
    blended toward the originals' under the earring masks and their 64²
    features under the background, then the teeth masks. A row whose
    `need_earring` is False gets no earring blend.

    styles, edited: [N, 26, 512]; gen2: (params, cfg) of a second
    generator that renders the edits. Returns (originals, blended edits),
    uint8 [N, H, W, 3] on the device."""
    e_params, e_cfg = gen2 if gen2 is not None else (gen_params, gen_cfg)

    def u8(img):
        # NHWC in memory too: the host's copies are then plain arrays,
        # which PIL reads without a strided gather under the GIL
        return to_u8_nhwc(img).contiguous()

    with record_function("editor.blend", rows=styles.shape[0]):
        xs_original, img0 = synthesis(
            gen_params, gen_cfg, styles, noise_mode=noise_mode,
            return_features={res for _, res in BLEND_MASKS})
        orig_u8 = u8(img0)
        # the originals' copy is queued before the edits' render, so the
        # host parses them while the device renders the edits
        orig_host = host_later(orig_u8)
        edit_u8 = u8(synthesis(e_params, e_cfg, edited,
                               noise_mode=noise_mode))
        masks = masks_of(segmenter, orig_host, host_later(edit_u8),
                         need_earring)
        blended = synthesis(e_params, e_cfg, edited, noise_mode=noise_mode,
                            blend_masks=_masks_on_device(masks,
                                                         styles.device),
                            xs_original=xs_original)
        return orig_u8, u8(blended)


def apply_edit_item_with_blending(gen_params, gen_cfg: GeneratorConfig,
                                  styles_item: torch.Tensor,
                                  direction: torch.Tensor,
                                  change_power: float, segmenter,
                                  text_prompt: str = "",
                                  noise_mode: str = "const",
                                  gen2: Optional[Tuple] = None):
    """One item with DeepLab feature blending: `blend_edits` on one row.
    `segmenter` is a `models.deeplab.Segmenter` or provides
    get_bg_mask(img_u8) and get_earring_mouth_teeth_masks(img_u8,
    need_earring_mask) on uint8 HWC images. No earring mask when the
    prompt contains 'face of a man'.

    Returns (orig_u8, edited_u8), uint8 HWC."""
    s = styles_item[None]
    orig, edited = blend_edits(gen_params, gen_cfg, s,
                               s + direction * change_power, segmenter,
                               [needs_earring_mask(text_prompt)],
                               noise_mode=noise_mode, gen2=gen2)
    return orig[0].cpu().numpy(), edited[0].cpu().numpy()
