"""Landmark-based triangle warping (counterpart of
`stylemc_tpu/cv/warp.py`): a Delaunay triangulation of the landmarks'
convex hull (cv2.Subdiv2D), per-triangle crops with masks, and the
piecewise-affine warp that moves one set of landmarks onto another. Host
code; cv2 is imported where it is used.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def triangle_indices(points: np.ndarray) -> List[List[int]]:
    """Delaunay triangulation of the convex hull; triangles as point-index
    triples (reference warp_images.py:25-52)."""
    import cv2

    points = np.asarray(points)
    convexhull = cv2.convexHull(points.astype(np.int32))
    landmarks_points = points.astype(np.int32)
    rect = cv2.boundingRect(convexhull)
    subdiv = cv2.Subdiv2D(rect)
    # OpenCV 5 requires float32 point lists for Subdiv2D.insert
    subdiv.insert([tuple(map(float, p)) for p in landmarks_points])
    triangles = np.array(subdiv.getTriangleList(), dtype=np.int32)

    def find_index(pt):
        # Subdiv2D vertices round-trip through the int32 cast above, so
        # match against the cast points — fractional detector landmarks
        # never equal their truncated triangle vertices.
        hit = np.where((landmarks_points == pt).all(axis=1))[0]
        return int(hit[0]) if len(hit) else None

    out = []
    for t in triangles:
        idx = [find_index((t[0], t[1])), find_index((t[2], t[3])),
               find_index((t[4], t[5]))]
        if all(i is not None for i in idx):
            out.append(idx)
    return out


def get_triangle_points(points: np.ndarray, triangle_idx,
                        img: Optional[np.ndarray] = None):
    """Crop one triangle region + its mask (reference warp_images.py:55-68)."""
    import cv2

    pts = np.array([points[triangle_idx[0]], points[triangle_idx[1]],
                    points[triangle_idx[2]]], np.int32)
    x, y, w, h = cv2.boundingRect(pts)
    local = pts - np.array([[x, y]], np.int32)
    mask = np.zeros((h, w), np.uint8)
    cropped = img[y:y + h, x:x + w] if img is not None else None
    return local, cropped, mask


def warp_triangle(src_img, dst_img, src_pts, dst_pts):
    """Affine-warp one triangle from src to dst in place (the standard
    piecewise warp the reference's tooling composes)."""
    import cv2

    src_pts = np.asarray(src_pts, np.float32)
    dst_pts = np.asarray(dst_pts, np.float32)
    r1 = cv2.boundingRect(src_pts.astype(np.int32))
    r2 = cv2.boundingRect(dst_pts.astype(np.int32))
    src_local = src_pts - np.array(r1[:2], np.float32)
    dst_local = dst_pts - np.array(r2[:2], np.float32)
    src_crop = src_img[r1[1]:r1[1] + r1[3], r1[0]:r1[0] + r1[2]]
    if src_crop.size == 0 or r2[2] == 0 or r2[3] == 0:
        return
    m = cv2.getAffineTransform(src_local, dst_local)
    warped = cv2.warpAffine(src_crop, m, (r2[2], r2[3]),
                            flags=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_REFLECT_101)
    mask = np.zeros((r2[3], r2[2]), np.uint8)
    cv2.fillConvexPoly(mask, dst_local.astype(np.int32), 255)
    # Destination landmarks can fall outside the image (detector boxes near
    # an edge): clip the destination rect to the image and slice the warped
    # patch/mask by the same offsets instead of indexing out of bounds.
    h, w = dst_img.shape[:2]
    x0, y0 = max(r2[0], 0), max(r2[1], 0)
    x1, y1 = min(r2[0] + r2[2], w), min(r2[1] + r2[3], h)
    if x0 >= x1 or y0 >= y1:
        return
    ox, oy = x0 - r2[0], y0 - r2[1]
    mask = mask[oy:oy + (y1 - y0), ox:ox + (x1 - x0)]
    warped = warped[oy:oy + (y1 - y0), ox:ox + (x1 - x0)]
    region = dst_img[y0:y1, x0:x1]
    region[mask > 0] = warped[mask > 0]


def warp_face(img: np.ndarray, src_landmarks: np.ndarray,
              dst_landmarks: np.ndarray) -> np.ndarray:
    """Piecewise-affine warp of `img` moving src landmarks to dst."""
    out = img.copy()
    for tri in triangle_indices(src_landmarks):
        warp_triangle(img, out, src_landmarks[tri], dst_landmarks[tri])
    return out
