"""Landmark overlays and warps over [orig|edited] pair images (counterpart
of `stylemc_tpu/cli/warp_images.py`).

For each side-by-side pair written by generate_fromS: split the halves,
find each half's landmarks (MTCNN → crop_face → MobileNet-GDConv, the nets
on --device, from --mtcnn_dir / STYLEMC_MTCNN_DIR and --mobilenet_path /
STYLEMC_MOBILENET), and write a strip of both halves with their landmarks
drawn, plus, with --warp, the original half warped piecewise-affinely so
its landmarks move onto the edited half's.

  python -m stylemc_torch.cli.warp_images --indir out --outdir warped
"""

from __future__ import annotations

import os

import click
import numpy as np


def _overlay(img: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
    """Draw landmark points (3x3 white dots) onto a copy of uint8 HWC."""
    out = img.copy()
    h, w = out.shape[:2]
    for x, y in np.asarray(landmarks, np.int64):
        if not (0 <= y < h and 0 <= x < w):
            continue  # out of frame; a negative slice end would wrap
        y0, y1 = max(0, y - 1), min(h, y + 2)
        x0, x1 = max(0, x - 1), min(w, x + 2)
        out[y0:y1, x0:x1] = 255
    return out


@click.command()
@click.option("--indir", type=str, required=True,
              help="directory of [orig|edited] pair images")
@click.option("--outdir", type=str, required=True)
@click.option("--warp/--no-warp", "do_warp", default=True,
              show_default=True,
              help="append the orig half warped onto the edited landmarks")
@click.option("--mtcnn_dir", type=str, default=None,
              help="MTCNN .npy weights dir (default: STYLEMC_MTCNN_DIR)")
@click.option("--mobilenet_path", type=str, default=None,
              help="MobileNet .tar checkpoint (default: STYLEMC_MOBILENET)")
@click.option("--device", default="cuda", show_default=True)
def main(indir, outdir, do_warp, mtcnn_dir, mobilenet_path, device):
    from PIL import Image

    from ..cv.landmarks import default_landmarker
    from ..cv.warp import warp_face
    from ..data.images import make_dataset

    landmarker = default_landmarker(weights_dir=mtcnn_dir,
                                    mobilenet_path=mobilenet_path,
                                    device=device)
    os.makedirs(outdir, exist_ok=True)
    paths = make_dataset(indir)
    n_ok = 0
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        half = img.shape[1] // 2
        left, right = img[:, :half], img[:, half:2 * half]
        lm = landmarker.detect_batch([left, right])
        if lm is None:
            print(f"no face: {p}")
            continue
        panels = [_overlay(left, lm[0]), _overlay(right, lm[1])]
        if do_warp:
            panels.append(warp_face(left, lm[0], lm[1]))
        strip = np.concatenate(panels, axis=1)
        name = os.path.splitext(os.path.basename(p))[0]
        Image.fromarray(strip).save(os.path.join(outdir, f"{name}_warp.jpeg"))
        n_ok += 1
    print(f"processed {n_ok}/{len(paths)}")


if __name__ == "__main__":
    main()
