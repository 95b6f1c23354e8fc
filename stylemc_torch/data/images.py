"""Image datasets (counterpart of `stylemc_tpu/data/images.py`): directory
listing, the e4e image transform (resize, then [0,1] → [-1,1]) and the
paired source/target dataset. The batch samplers and the prefetcher wait
for the e4e trainer."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def make_dataset(directory: str) -> List[str]:
    """Image paths under `directory`, walked in sorted order."""
    paths = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if fname.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(root, fname))
    return paths


def load_image(path: str, size: int = 256) -> np.ndarray:
    """→ float32 [3, size, size] in [-1, 1]: PIL bilinear resize, /255,
    then (x - 0.5) / 0.5."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr.transpose(2, 0, 1)


@dataclasses.dataclass
class ImagesDataset:
    """Paired source/target dataset; without target_root each source is
    its own target."""
    source_root: str
    target_root: Optional[str] = None
    size: int = 256

    def __post_init__(self):
        self.source_paths = make_dataset(self.source_root)
        self.target_paths = make_dataset(self.target_root) \
            if self.target_root else self.source_paths

    def __len__(self):
        return len(self.source_paths)

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        return (load_image(self.source_paths[idx], self.size),
                load_image(self.target_paths[idx], self.size))
