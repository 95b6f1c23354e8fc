"""FFHQ-align the faces of a directory of photos (counterpart of
`stylemc_tpu/cli/align_faces.py`): detect each photo's landmarks (MTCNN +
MobileNet-GDConv from STYLEMC_MTCNN_DIR and STYLEMC_MOBILENET) and write
the aligned crop under the same name. Photos without a face are reported
and skipped. Runs the nets on --device (cuda unless told otherwise).

  python -m stylemc_torch.cli.align_faces --images_dir photos \\
      --out_dir aligned --output_size 256
"""

from __future__ import annotations

import os

import click
import numpy as np


@click.command()
@click.option("--images_dir", type=str, required=True)
@click.option("--out_dir", type=str, required=True)
@click.option("--output_size", type=int, default=1024, show_default=True)
@click.option("--transform_size", type=int, default=4096, show_default=True)
@click.option("--device", default="cuda", show_default=True)
def main(images_dir, out_dir, output_size, transform_size, device):
    from PIL import Image

    from ..cv.align import align_face
    from ..cv.landmarks import default_landmarker
    from ..data.images import make_dataset

    landmarker = default_landmarker(device=device)
    os.makedirs(out_dir, exist_ok=True)
    paths = make_dataset(images_dir)
    n_ok = 0
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        lm = landmarker.detect(img)
        if lm is None:
            print(f"no face: {p}")
            continue
        aligned = align_face(img, lm, output_size=output_size,
                             transform_size=transform_size)
        aligned.save(os.path.join(out_dir, os.path.basename(p)))
        n_ok += 1
    print(f"aligned {n_ok}/{len(paths)}")


if __name__ == "__main__":
    main()
