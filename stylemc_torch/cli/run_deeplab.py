"""Batch face parsing to `parsings/` masks (counterpart of
`stylemc_tpu/cli/run_deeplab.py`): segment every image under
--dataset_root at 513² and save its class-index map, resized to
--resolution (nearest), as <dataset_root>/parsings/<name>.png. Runs on
--device (cuda unless told otherwise).

  python -m stylemc_torch.cli.run_deeplab --dataset_root out \
      --ckpt deeplab_model.pth
"""

from __future__ import annotations

import os

import click
import numpy as np


@click.command()
@click.option("--resolution", type=int, default=512,
              help="segmentation output size")
@click.option("--dataset_root", type=str, required=True,
              help="Folder with images")
@click.option("--ckpt", "ckpt_path", type=str, default=None,
              help="deeplab_model.pth (or set STYLEMC_DEEPLAB)")
@click.option("--device", default="cuda", show_default=True)
def main(resolution, dataset_root, ckpt_path, device):
    from PIL import Image

    from ..data.images import make_dataset
    from ..models.deeplab import default_segmenter

    segmenter = default_segmenter(ckpt_path, resolution=resolution,
                                  device=device)
    paths = [p for p in make_dataset(dataset_root) if "parsings" not in p]
    outdir = os.path.join(dataset_root, "parsings")
    os.makedirs(outdir, exist_ok=True)
    for i, p in enumerate(paths):
        img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        mask = segmenter.segment(img)
        name = os.path.splitext(os.path.basename(p))[0] + ".png"
        Image.fromarray(mask).save(os.path.join(outdir, name))
        if i % 50 == 0:
            print(f"{i}/{len(paths)}")
    print(f"saved {len(paths)} parsings to {outdir}")


if __name__ == "__main__":
    main()
