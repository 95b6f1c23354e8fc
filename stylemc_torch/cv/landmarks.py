"""Landmark detection: MTCNN → crop_face → MobileNet-GDConv → back to image
coordinates (counterpart of `stylemc_tpu/cv/landmarks.py`).

crop_face takes a 1.2x square around the best box, zero-bordered where it
leaves the image, resized to 224² by OpenCV (`cv2.resize`, INTER_LINEAR,
as the reference does); the landmarks map back as lm·crop_size +
box origin. The two nets run on the landmarker's device.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def crop_face(img: np.ndarray, faces, out_size: int = 224):
    """img: uint8 HWC. faces: [n, 5] boxes (the first is used). →
    (cropped uint8 [out, out, 3], the crop's side before resizing, the
    box clipped to the image [x1, y1, x2, y2])."""
    import cv2

    height, width = img.shape[:2]
    x1, y1, x2, y2 = faces[0][:4]
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    size = int(min([w, h]) * 1.2)
    cx = x1 + w // 2
    cy = y1 + h // 2
    x1 = cx - size // 2
    x2 = x1 + size
    y1 = cy - size // 2
    y2 = y1 + size

    dx = max(0, -x1)
    dy = max(0, -y1)
    x1 = max(0, x1)
    y1 = max(0, y1)
    edx = max(0, x2 - width)
    edy = max(0, y2 - height)
    x2 = min(width, x2)
    y2 = min(height, y2)
    new_bbox = list(map(int, [x1, y1, x2, y2]))

    cropped = img[new_bbox[1]:new_bbox[3], new_bbox[0]:new_bbox[2]]
    if dx > 0 or dy > 0 or edx > 0 or edy > 0:
        cropped = cv2.copyMakeBorder(cropped, int(dy), int(edy), int(dx),
                                     int(edx), cv2.BORDER_CONSTANT, 0)
    cropped_face = cv2.resize(cropped, (out_size, out_size))
    return cropped_face, cropped.shape[0], new_bbox


def normalize_crop(crop: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] in [0, 1] → ImageNet-normalised."""
    from ..models.mobilenet import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.tensor(IMAGENET_MEAN, device=crop.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=crop.device).reshape(1, 3, 1, 1)
    return (crop - mean) / std


class Landmarker:
    """MTCNN + MobileNet-GDConv, both on the device of the MobileNet
    params."""

    def __init__(self, mtcnn, mobilenet_params, out_size: int = 224):
        self.mtcnn = mtcnn
        self.params = mobilenet_params
        self.out_size = out_size
        self.device = mobilenet_params["stem"]["conv"].device

    def detect(self, image: np.ndarray) -> Optional[np.ndarray]:
        """image: uint8 HWC → [68, 2] landmarks in image coordinates of
        the highest-scoring face, or None."""
        from ..models.mobilenet import mobilenet_gdconv_apply
        from ..models.mtcnn.detect import detect_faces

        faces, _ = detect_faces(image, self.mtcnn)
        if len(faces) == 0:
            return None
        best = faces[np.argmax(faces[:, 4])]
        cropped, orig_size, bbox = crop_face(image, [best], self.out_size)
        x = torch.from_numpy(cropped.astype(np.float32).transpose(2, 0, 1)
                             [None]).to(self.device)
        with torch.no_grad():
            lm = mobilenet_gdconv_apply(self.params,
                                        normalize_crop(x / 255.0))
        lm = lm.cpu().numpy().reshape(-1, 2)
        return lm * orig_size + np.asarray([bbox[0], bbox[1]])[None]

    def detect_batch(self, images: List[np.ndarray]) -> Optional[np.ndarray]:
        """[N, 68, 2], or None if any image has no face."""
        out = []
        for img in images:
            lm = self.detect(img)
            if lm is None:
                return None
            out.append(lm)
        return np.stack(out)


def default_landmarker(weights_dir: Optional[str] = None,
                       mobilenet_path: Optional[str] = None,
                       device: DeviceLike = None) -> Landmarker:
    """From STYLEMC_MTCNN_DIR (the {p,r,o}net.npy dir) and
    STYLEMC_MOBILENET (mobilenet_224_model_best_gdconv_external.pth.tar),
    or the explicit paths."""
    from ..convert import params_from_numpy
    from ..io.torch_state import load_state_dict_numpy
    from ..models import mobilenet as mb
    from ..models.mtcnn.detect import MTCNN

    dev = resolve_device(device)
    weights_dir = weights_dir or os.environ.get("STYLEMC_MTCNN_DIR")
    mobilenet_path = mobilenet_path or os.environ.get("STYLEMC_MOBILENET")
    if not weights_dir or not os.path.isdir(weights_dir):
        raise FileNotFoundError("set STYLEMC_MTCNN_DIR to the MTCNN .npy dir")
    if not mobilenet_path or not os.path.exists(mobilenet_path):
        raise FileNotFoundError(
            "set STYLEMC_MOBILENET to "
            "mobilenet_224_model_best_gdconv_external.pth.tar")
    mtcnn = MTCNN.from_weights_dir(weights_dir, dev)
    state = load_state_dict_numpy(mobilenet_path, key="state_dict")
    return Landmarker(mtcnn, params_from_numpy(
        mb.params_from_torch_state(state), dev))
