"""Detection overlays (counterpart of
`stylemc_tpu/models/mtcnn/visualize.py`): [n, 5] boxes as white rectangles
and [n, 10] landmarks (x0..x4, y0..y4) as blue dots, drawn onto a copy of
a PIL.Image or a uint8 HWC array.
"""

from __future__ import annotations

import numpy as np


def show_bboxes(img, bounding_boxes, facial_landmarks=()):
    """Return a PIL.Image copy with boxes/landmarks drawn."""
    from PIL import Image, ImageDraw

    if isinstance(img, np.ndarray):
        img = Image.fromarray(np.ascontiguousarray(img))
    out = img.copy()
    draw = ImageDraw.Draw(out)

    for b in bounding_boxes:
        draw.rectangle([(float(b[0]), float(b[1])),
                        (float(b[2]), float(b[3]))], outline="white")

    for p in facial_landmarks:
        for i in range(5):
            x, y = float(p[i]), float(p[i + 5])
            draw.ellipse([(x - 1.0, y - 1.0), (x + 1.0, y + 1.0)],
                         outline="blue")
    return out
