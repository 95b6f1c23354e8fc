"""ctypes wrappers of the repository's host-ops library (counterpart of
`stylemc_tpu/native/`). Each returns None where the library is not
available, and the caller takes its numpy path; `calls` counts the calls
that went through the library."""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from .build import build_host_ops, get_host_ops

__all__ = ["build_host_ops", "get_host_ops", "native_available", "calls",
           "nms_native", "extract_image_boxes_native",
           "resize_bilinear_u8_native", "u8_to_chw_norm_native"]

calls = {"nms": 0, "extract_image_boxes": 0, "resize_bilinear_u8": 0,
         "u8_to_chw_norm": 0}


def native_available() -> bool:
    return get_host_ops() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def nms_native(boxes: np.ndarray, overlap_threshold: float = 0.5,
               mode: str = "union") -> Optional[List[int]]:
    lib = get_host_ops()
    if lib is None:
        return None
    boxes = np.ascontiguousarray(boxes[:, :5], np.float32)
    n = boxes.shape[0]
    keep = np.zeros(n, np.int32)
    k = lib.nms(_ptr(boxes, ctypes.c_float), ctypes.c_int(n),
                ctypes.c_float(overlap_threshold),
                ctypes.c_int(1 if mode == "min" else 0),
                _ptr(keep, ctypes.c_int32))
    calls["nms"] += 1
    return keep[:k].tolist()


def extract_image_boxes_native(img_u8: np.ndarray, boxes: np.ndarray,
                               size: int) -> Optional[np.ndarray]:
    lib = get_host_ops()
    if lib is None:
        return None
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an HWC RGB image, got {img.shape}")
    b = np.ascontiguousarray(boxes, np.float32)
    out = np.zeros((b.shape[0], 3, size, size), np.float32)
    lib.extract_image_boxes(
        _ptr(img, ctypes.c_uint8), ctypes.c_int(img.shape[0]),
        ctypes.c_int(img.shape[1]), _ptr(b, ctypes.c_float),
        ctypes.c_int(b.shape[0]), ctypes.c_int(b.shape[1]),
        ctypes.c_int(size), _ptr(out, ctypes.c_float))
    calls["extract_image_boxes"] += 1
    return out


def resize_bilinear_u8_native(img_u8: np.ndarray, dh: int, dw: int
                              ) -> Optional[np.ndarray]:
    lib = get_host_ops()
    if lib is None:
        return None
    img = np.ascontiguousarray(img_u8, np.uint8)
    out = np.zeros((dh, dw, img.shape[2]), np.uint8)
    lib.resize_bilinear_u8(
        _ptr(img, ctypes.c_uint8), ctypes.c_int(img.shape[0]),
        ctypes.c_int(img.shape[1]), ctypes.c_int(img.shape[2]),
        _ptr(out, ctypes.c_uint8), ctypes.c_int(dh), ctypes.c_int(dw))
    calls["resize_bilinear_u8"] += 1
    return out


def u8_to_chw_norm_native(img_u8: np.ndarray) -> Optional[np.ndarray]:
    lib = get_host_ops()
    if lib is None:
        return None
    img = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img.shape
    out = np.zeros((3, h, w), np.float32)
    lib.u8_to_chw_norm(_ptr(img, ctypes.c_uint8), ctypes.c_int(h),
                       ctypes.c_int(w), _ptr(out, ctypes.c_float))
    calls["u8_to_chw_norm"] += 1
    return out
