"""Image datasets and host-side batch iterators (counterpart of
`stylemc_tpu/data/images.py`): directory listing, the e4e image transform
(resize, then [0,1] → [-1,1]), the paired source/target dataset, the
infinite windowed-shuffle sampler, the batch iterator with the training
flip, and a background-thread prefetcher. The samplers draw from numpy
`RandomState`s in the JAX package's order, so index orders and flips are
the same in both packages."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Tuple

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
    flip: bool = False

    def __post_init__(self):
        self.source_paths = make_dataset(self.source_root)
        self.target_paths = make_dataset(self.target_root) \
            if self.target_root else self.source_paths

    def __len__(self):
        return len(self.source_paths)

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        return (load_image(self.source_paths[idx], self.size),
                load_image(self.target_paths[idx], self.size))


def infinite_sampler(dataset_size: int, rank: int = 0, num_replicas: int = 1,
                     shuffle: bool = True, seed: int = 0,
                     window_size: float = 0.5):
    """Infinite rank-strided index stream with windowed shuffling."""
    assert dataset_size > 0
    order = np.arange(dataset_size)
    rnd = None
    window = 0
    if shuffle:
        rnd = np.random.RandomState(seed)
        rnd.shuffle(order)
        window = int(np.rint(order.size * window_size))
    idx = 0
    while True:
        i = idx % order.size
        if idx % num_replicas == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


def prefetch_iterator(next_batch: Callable, depth: int = 2) -> Callable:
    """Wrap a batch callable with a background thread and a queue of
    `depth` batches, so image decoding overlaps the device's steps."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        while True:
            q.put(next_batch())

    threading.Thread(target=worker, daemon=True).start()
    return q.get


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   flip: bool = False, seed: int = 0,
                   prefetch: int = 0) -> Callable:
    """→ a callable returning (x, y) numpy batches forever (the last
    partial batch of each pass dropped); with `flip`, each pair is
    mirrored left-right with probability 1/2. prefetch > 0 decodes ahead
    on a background thread."""
    rng = np.random.RandomState(seed)
    order = np.arange(len(dataset))
    pos = [len(dataset)]  # reshuffle on the first call

    def next_batch():
        if pos[0] + batch_size > len(dataset):
            if shuffle:
                rng.shuffle(order)
            pos[0] = 0
        idx = order[pos[0]:pos[0] + batch_size]
        pos[0] += batch_size
        xs, ys = zip(*(dataset[i] for i in idx))
        x = np.stack(xs)
        y = np.stack(ys)
        if flip:
            do = rng.rand(len(x)) < 0.5
            x[do] = x[do, :, :, ::-1]
            y[do] = y[do, :, :, ::-1]
        return x, y

    if prefetch > 0:
        return prefetch_iterator(next_batch, depth=prefetch)
    return next_batch
