"""FFHQ face alignment from 68 landmarks (counterpart of
`stylemc_tpu/cv/align.py`): the oriented quad from the eye and mouth
geometry, shrink, crop, reflect-pad with blurred feathering, PIL's QUAD
transform and a LANCZOS resize. The landmarks come from the MTCNN +
MobileNet pipeline (`cv/landmarks.py`). Host code (numpy, scipy, PIL).
"""

from __future__ import annotations

import numpy as np


def align_face(image: np.ndarray, landmarks: np.ndarray,
               output_size: int = 1024, transform_size: int = 4096,
               enable_padding: bool = True, rotate_level: bool = True):
    """image: uint8 HWC; landmarks: [68, 2] → the aligned PIL image."""
    import scipy.ndimage
    from PIL import Image

    lm = np.asarray(landmarks, np.float64).copy()
    lm_eye_left = lm[36:42]
    lm_eye_right = lm[42:48]
    lm_mouth_outer = lm[48:60]

    eye_left = np.mean(lm_eye_left, axis=0)
    eye_right = np.mean(lm_eye_right, axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_left = lm_mouth_outer[0]
    mouth_right = lm_mouth_outer[6]
    mouth_avg = (mouth_left + mouth_right) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    if rotate_level:
        x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
        x /= np.hypot(*x)
        x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
        y = np.flipud(x) * [-1, 1]
        c0 = eye_avg + eye_to_mouth * 0.1
    else:
        x = np.array([1, 0], dtype=np.float64)
        x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
        y = np.flipud(x) * [-1, 1]
        c0 = eye_avg + eye_to_mouth * 0.1

    img = Image.fromarray(np.asarray(image, np.uint8))
    quad = np.stack([c0 - x - y, c0 - x + y, c0 + x + y, c0 + x - y])
    qsize = np.hypot(*x) * 2

    # Shrink.
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(float(img.size[0]) / shrink)),
                 int(np.rint(float(img.size[1]) / shrink)))
        img = img.resize(rsize, Image.LANCZOS)
        quad /= shrink
        qsize /= shrink

    # Crop.
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
            int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, img.size[0]),
            min(crop[3] + border, img.size[1]))
    if crop[2] - crop[0] < img.size[0] or crop[3] - crop[1] < img.size[1]:
        img = img.crop(crop)
        quad -= crop[0:2]

    # Pad.
    pad = (int(np.floor(min(quad[:, 0]))), int(np.floor(min(quad[:, 1]))),
           int(np.ceil(max(quad[:, 0]))), int(np.ceil(max(quad[:, 1]))))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - img.size[0] + border, 0),
           max(pad[3] - img.size[1] + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad[0],
                             np.float32(w - 1 - xx) / pad[2]),
            1.0 - np.minimum(np.float32(yy) / pad[1],
                             np.float32(h - 1 - yy) / pad[3]))
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) * \
            np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = Image.fromarray(np.uint8(np.clip(np.rint(arr), 0, 255)), "RGB")
        quad += pad[:2]

    # Transform.
    img = img.transform((transform_size, transform_size), Image.QUAD,
                        (quad + 0.5).flatten(), Image.BILINEAR)
    if output_size < transform_size:
        img = img.resize((output_size, output_size), Image.LANCZOS)
    return img


def align_face_file(path: str, landmarker=None, output_size: int = 1024,
                    transform_size: int = 4096, device=None):
    """Detect the landmarks of an image file and FFHQ-align it; raises
    ValueError where no face is found. Without `landmarker`, the one of
    `default_landmarker` on `device`."""
    from PIL import Image
    from .landmarks import default_landmarker

    image = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    landmarker = landmarker or default_landmarker(device=device)
    lm = landmarker.detect(image)
    if lm is None:
        raise ValueError(f"no face found in {path}")
    return align_face(image, lm, output_size=output_size,
                      transform_size=transform_size)
