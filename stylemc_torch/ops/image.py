"""Differentiable face crop for the in-graph landmarks loss (counterpart of
`stylemc_tpu/ops/image.py`).

`crop_resize_bilinear` is the host crop of `cv/landmarks.crop_face` (a
square box, zero border outside the image, bilinear resize to 224² with
cv2's half-pixel convention) as two batched contractions per sample, so
the gradient flows to the image. Samples outside the image get zero
weight: the zero border.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_weights(starts: torch.Tensor, stops: torch.Tensor, in_size: int,
                  out_size: int) -> torch.Tensor:
    """[B, out, in] bilinear weights sampling [start, stop) onto `out`
    pixels: src = start + (j + 0.5)·scale − 0.5 with scale =
    (stop − start)/out, clamped into the crop [start, stop − 1] (the
    resize replicates the crop's edge); rows outside [0, in) weigh 0."""
    j = torch.arange(out_size, dtype=starts.dtype,
                     device=starts.device) + 0.5
    scale = (stops - starts) / out_size
    src = j[None, :] * scale[:, None] - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0),
                        (stops - starts)[:, None] - 1.0)
    src = src + starts[:, None]
    r = torch.arange(in_size, dtype=starts.dtype, device=starts.device)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - r[None, None, :]),
                       min=0.0)


def crop_resize_bilinear(img: torch.Tensor, boxes, out_size: int = 224
                         ) -> torch.Tensor:
    """img: [B, C, H, W] float. boxes: [B, 4] (x1, y1, x2, y2) pixel
    coordinates, which may extend past the borders. Returns [B, C, out,
    out] in float32 (float64 for a float64 img), differentiable with
    respect to img (the boxes are data)."""
    _, _, h, w = img.shape
    dtype = torch.float64 if img.dtype == torch.float64 else torch.float32
    boxes = torch.as_tensor(boxes, device=img.device).to(dtype)
    wy = _axis_weights(boxes[:, 1], boxes[:, 3], h, out_size)
    wx = _axis_weights(boxes[:, 0], boxes[:, 2], w, out_size)
    return torch.einsum("boh,bchw,bpw->bcop", wy, img.to(dtype), wx)


def square_crop_box(face_box, margin: float = 1.2) -> np.ndarray:
    """crop_face's box rule in float form: a square of side
    int(min(w, h)·margin) on the integer box centre. face_box: (x1, y1, x2,
    y2[, score]). Returns np [4] float32."""
    x1, y1, x2, y2 = [float(v) for v in face_box[:4]]
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    size = int(min(w, h) * margin)
    cx = x1 + w // 2
    cy = y1 + h // 2
    nx1 = cx - size // 2
    ny1 = cy - size // 2
    return np.asarray([nx1, ny1, nx1 + size, ny1 + size], np.float32)
