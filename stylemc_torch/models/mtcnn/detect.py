"""The MTCNN three-stage face detection cascade (counterpart of
`stylemc_tpu/models/mtcnn/detect.py`): an image pyramid (factor 0.707,
min_detection_size 12), P-Net sliding detection with per-scale NMS, a
global NMS, calibration and squaring, R-Net on 24² crops, O-Net on 48²
crops with five landmarks, a final 'min'-mode NMS.

The three nets run on the device of their params; the pyramid, the box
geometry, the NMS and the crop extraction run on the host, NMS and the
crops through the native library (`stylemc_torch.native`) where it builds.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike
from .nets import load_net_weights, onet_apply, pnet_apply, rnet_apply


# ------------------------------------------------------------ box utilities


def nms(boxes: np.ndarray, overlap_threshold: float = 0.5,
        mode: str = "union") -> List[int]:
    """Greedy non-maximum suppression over [n, 5] (x1, y1, x2, y2, score)
    rows; the kept indices, best first."""
    if len(boxes) == 0:
        return []
    from ...native import nms_native

    keep = nms_native(np.asarray(boxes, np.float32), overlap_threshold, mode)
    if keep is not None:
        return keep
    pick = []
    x1, y1, x2, y2, score = [boxes[:, i] for i in range(5)]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    ids = np.argsort(score)
    while len(ids) > 0:
        last = len(ids) - 1
        i = ids[last]
        pick.append(i)
        ix1 = np.maximum(x1[i], x1[ids[:last]])
        iy1 = np.maximum(y1[i], y1[ids[:last]])
        ix2 = np.minimum(x2[i], x2[ids[:last]])
        iy2 = np.minimum(y2[i], y2[ids[:last]])
        w = np.maximum(0.0, ix2 - ix1 + 1.0)
        h = np.maximum(0.0, iy2 - iy1 + 1.0)
        inter = w * h
        if mode == "min":
            overlap = inter / np.minimum(area[i], area[ids[:last]])
        else:
            overlap = inter / (area[i] + area[ids[:last]] - inter)
        ids = np.delete(ids, np.concatenate(
            [[last], np.where(overlap > overlap_threshold)[0]]))
    return pick


def convert_to_square(bboxes: np.ndarray) -> np.ndarray:
    square = np.zeros_like(bboxes)
    x1, y1, x2, y2 = [bboxes[:, i] for i in range(4)]
    h = y2 - y1 + 1.0
    w = x2 - x1 + 1.0
    max_side = np.maximum(h, w)
    square[:, 0] = x1 + w * 0.5 - max_side * 0.5
    square[:, 1] = y1 + h * 0.5 - max_side * 0.5
    square[:, 2] = square[:, 0] + max_side - 1.0
    square[:, 3] = square[:, 1] + max_side - 1.0
    if bboxes.shape[1] > 4:
        square[:, 4:] = bboxes[:, 4:]
    return square


def calibrate_box(bboxes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    x1, y1, x2, y2 = [bboxes[:, i] for i in range(4)]
    w = (x2 - x1 + 1.0)[:, None]
    h = (y2 - y1 + 1.0)[:, None]
    out = bboxes.copy()
    out[:, 0:4] = bboxes[:, 0:4] + np.hstack([w, h, w, h]) * offsets
    return out


def correct_bboxes(bboxes, width, height):
    """Each box clipped to the image, with where its clipped part lies in
    the box: (dy, edy, dx, edx, y, ey, x, ex, w, h), int32 arrays."""
    x1, y1, x2, y2 = [bboxes[:, i] for i in range(4)]
    w, h = x2 - x1 + 1.0, y2 - y1 + 1.0
    n = bboxes.shape[0]
    x, y, ex, ey = x1.copy(), y1.copy(), x2.copy(), y2.copy()
    dx, dy = np.zeros((n,)), np.zeros((n,))
    edx, edy = w.copy() - 1.0, h.copy() - 1.0

    ind = ex > width - 1.0
    edx[ind] = w[ind] + width - 2.0 - ex[ind]
    ex[ind] = width - 1.0
    ind = ey > height - 1.0
    edy[ind] = h[ind] + height - 2.0 - ey[ind]
    ey[ind] = height - 1.0
    ind = x < 0.0
    dx[ind] = -x[ind]
    x[ind] = 0.0
    ind = y < 0.0
    dy[ind] = -y[ind]
    y[ind] = 0.0
    return [a.astype("int32") for a in
            (dy, edy, dx, edx, y, ey, x, ex, w, h)]


def _preprocess(img: np.ndarray) -> np.ndarray:
    """HWC float → [1, C, H, W], (x − 127.5)·0.0078125."""
    img = img.transpose(2, 0, 1)[None]
    return (img - 127.5) * 0.0078125


def _resize_bilinear_pil(arr: np.ndarray, size: Tuple[int, int]
                         ) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(arr.astype(np.uint8)).resize(size, Image.BILINEAR),
        np.float32)


def get_image_boxes(bounding_boxes, img_array: np.ndarray,
                    size: int = 24) -> np.ndarray:
    """Cut out each box (zero outside the image), resize to size², and
    normalise: [n, 3, size, size] float32."""
    from ...native import extract_image_boxes_native

    native = extract_image_boxes_native(
        img_array, np.asarray(bounding_boxes, np.float32), size)
    if native is not None:
        return native
    height, width = img_array.shape[:2]
    dy, edy, dx, edx, y, ey, x, ex, w, h = correct_bboxes(
        bounding_boxes, width, height)
    out = np.zeros((len(bounding_boxes), 3, size, size), np.float32)
    for i in range(len(bounding_boxes)):
        if h[i] <= 0 or w[i] <= 0:
            continue
        box = np.zeros((h[i], w[i], 3), np.uint8)
        box[dy[i]:edy[i] + 1, dx[i]:edx[i] + 1] = \
            img_array[y[i]:ey[i] + 1, x[i]:ex[i] + 1]
        out[i] = _preprocess(_resize_bilinear_pil(box, (size, size)))[0]
    return out


# --------------------------------------------------------------- the cascade


class MTCNN:
    """The three nets' params on one device, and their forward passes
    (numpy in, numpy out)."""

    def __init__(self, pnet_params, rnet_params, onet_params):
        self.params = {"pnet": pnet_params, "rnet": rnet_params,
                       "onet": onet_params}
        self.device = pnet_params["features.conv1.weight"].device

    def _run(self, apply, name, x: np.ndarray):
        with torch.no_grad():
            out = apply(self.params[name],
                        torch.from_numpy(np.ascontiguousarray(
                            x, np.float32)).to(self.device))
        return tuple(o.cpu().numpy() for o in out)

    def pnet(self, x):
        return self._run(pnet_apply, "pnet", x)

    def rnet(self, x):
        return self._run(rnet_apply, "rnet", x)

    def onet(self, x):
        return self._run(onet_apply, "onet", x)

    @classmethod
    def from_weights_dir(cls, weights_dir: str, device: DeviceLike = None
                         ) -> "MTCNN":
        return cls(*(load_net_weights(os.path.join(weights_dir,
                                                   f"{name}.npy"), device)
                     for name in ("pnet", "rnet", "onet")))


def _generate_bboxes(probs, offsets, scale, threshold):
    stride, cell_size = 2, 12
    inds = np.where(probs > threshold)
    if inds[0].size == 0:
        return np.array([])
    offs = np.array([offsets[0, i, inds[0], inds[1]] for i in range(4)])
    score = probs[inds[0], inds[1]]
    boxes = np.vstack([
        np.round((stride * inds[1] + 1.0) / scale),
        np.round((stride * inds[0] + 1.0) / scale),
        np.round((stride * inds[1] + 1.0 + cell_size) / scale),
        np.round((stride * inds[0] + 1.0 + cell_size) / scale),
        score, offs,
    ])
    return boxes.T


def run_first_stage(img_array: np.ndarray, mtcnn: MTCNN, scale: float,
                    threshold: float) -> Optional[np.ndarray]:
    height, width = img_array.shape[:2]
    sw, sh = math.ceil(width * scale), math.ceil(height * scale)
    img = _resize_bilinear_pil(img_array, (sw, sh))
    offsets, probs = mtcnn.pnet(_preprocess(img))
    boxes = _generate_bboxes(probs[0, 1], offsets, scale, threshold)
    if len(boxes) == 0:
        return None
    keep = nms(boxes[:, 0:5], overlap_threshold=0.5)
    return boxes[keep]


def detect_faces(image, mtcnn: MTCNN, min_face_size: float = 20.0,
                 thresholds=(0.6, 0.7, 0.8),
                 nms_thresholds=(0.7, 0.7, 0.7)):
    """image: uint8 HWC array (or PIL image) → (boxes [n, 5], landmarks
    [n, 10]); ([], []) where no face is found."""
    if hasattr(image, "size") and not isinstance(image, np.ndarray):
        image = np.asarray(image.convert("RGB"), np.uint8)
    image = np.asarray(image).astype(np.uint8)
    height, width = image.shape[:2]

    min_detection_size = 12
    factor = 0.707
    scales = []
    m = min_detection_size / min_face_size
    min_length = min(height, width) * m
    factor_count = 0
    while min_length > min_detection_size:
        scales.append(m * factor ** factor_count)
        min_length *= factor
        factor_count += 1

    # stage 1: P-Net over the pyramid
    bounding_boxes = [run_first_stage(image, mtcnn, s, thresholds[0])
                      for s in scales]
    bounding_boxes = [b for b in bounding_boxes if b is not None]
    if not bounding_boxes:
        return [], []
    bounding_boxes = np.vstack(bounding_boxes)
    keep = nms(bounding_boxes[:, 0:5], nms_thresholds[0])
    bounding_boxes = bounding_boxes[keep]
    bounding_boxes = calibrate_box(bounding_boxes[:, 0:5],
                                   bounding_boxes[:, 5:])
    bounding_boxes = convert_to_square(bounding_boxes)
    bounding_boxes[:, 0:4] = np.round(bounding_boxes[:, 0:4])

    # stage 2: R-Net on 24² crops
    img_boxes = get_image_boxes(bounding_boxes, image, size=24)
    if len(img_boxes) == 0:
        return [], []
    offsets, probs = mtcnn.rnet(img_boxes)
    keep = np.where(probs[:, 1] > thresholds[1])[0]
    bounding_boxes = bounding_boxes[keep]
    bounding_boxes[:, 4] = probs[keep, 1]
    offsets = offsets[keep]
    keep = nms(bounding_boxes, nms_thresholds[1])
    bounding_boxes = calibrate_box(bounding_boxes[keep], offsets[keep])
    bounding_boxes = convert_to_square(bounding_boxes)
    bounding_boxes[:, 0:4] = np.round(bounding_boxes[:, 0:4])

    # stage 3: O-Net on 48² crops, with landmarks
    img_boxes = get_image_boxes(bounding_boxes, image, size=48)
    if len(img_boxes) == 0:
        return [], []
    landmarks, offsets, probs = mtcnn.onet(img_boxes)
    keep = np.where(probs[:, 1] > thresholds[2])[0]
    bounding_boxes = bounding_boxes[keep]
    bounding_boxes[:, 4] = probs[keep, 1]
    offsets = offsets[keep]
    landmarks = landmarks[keep].copy()

    w = bounding_boxes[:, 2] - bounding_boxes[:, 0] + 1.0
    h = bounding_boxes[:, 3] - bounding_boxes[:, 1] + 1.0
    xmin, ymin = bounding_boxes[:, 0], bounding_boxes[:, 1]
    landmarks[:, 0:5] = xmin[:, None] + w[:, None] * landmarks[:, 0:5]
    landmarks[:, 5:10] = ymin[:, None] + h[:, None] * landmarks[:, 5:10]

    bounding_boxes = calibrate_box(bounding_boxes, offsets)
    keep = nms(bounding_boxes, nms_thresholds[2], mode="min")
    return bounding_boxes[keep], landmarks[keep]
