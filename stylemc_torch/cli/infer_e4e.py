"""Real photos → W+ codes through an e4e checkpoint: encode every image of
--images_dir at 256² in batches of --batch (the last padded by repeating
its last image) and save the codes to <save_dir>/projected_w.npz (key 'w')
for w_s_converter. --save_images also writes each reconstruction, decoded
by the checkpoint's own generator and pooled to 256², to
<save_dir>/inversions/<image name>. --align first FFHQ-aligns each photo
to 256² from its landmarks (MTCNN + MobileNet-GDConv from STYLEMC_MTCNN_DIR
and STYLEMC_MOBILENET, on --device); a photo without a face stops the run.

  python -m stylemc_torch.cli.infer_e4e --images_dir photos \\
      --ckpt e4e_ffhq_encode.pt --save_dir out/e4e
  python -m stylemc_torch.cli.w_s_converter --network decoder.pt \\
      --projected-w out/e4e/projected_w.npz --out_file out/input.npz
"""

from __future__ import annotations

import os
import time

import click
import numpy as np
import torch


@click.command()
@click.option("--images_dir", type=str, required=True)
@click.option("--ckpt", "checkpoint_path", type=str, required=True,
              help="e4e checkpoint (e4e_ffhq_encode.pt)")
@click.option("--save_dir", type=str, default="encoder4editing")
@click.option("--align/--no-align", default=False,
              help="FFHQ-align faces before encoding (needs the MTCNN and "
                   "MobileNet weights)")
@click.option("--stylegan_size", type=int, default=1024)
@click.option("--batch", type=int, default=4)
@click.option("--save_images", is_flag=True, default=False,
              help="also save the inverted reconstructions")
@click.option("--device", default="cuda", show_default=True)
def main(images_dir, checkpoint_path, save_dir, align, stylegan_size, batch,
         save_images, device):
    from PIL import Image

    from ..data.images import load_image, make_dataset
    from ..device import disable_tf32, resolve_device
    from ..edit import to_uint8_hwc
    from ..models.e4e.psp import load_psp_from_checkpoint

    dev = resolve_device(device)
    disable_tf32(dev)
    psp = load_psp_from_checkpoint(checkpoint_path, stylegan_size, device=dev)
    paths = make_dataset(images_dir)
    print(f"inverting {len(paths)} images")
    os.makedirs(save_dir, exist_ok=True)
    if save_images:
        os.makedirs(os.path.join(save_dir, "inversions"), exist_ok=True)

    landmarker = None
    if align:
        from ..cv.align import align_face_file
        from ..cv.landmarks import default_landmarker

        landmarker = default_landmarker(device=dev)

    def load(path):
        if landmarker is None:
            return load_image(path, 256)
        aligned = align_face_file(path, landmarker, output_size=256)
        return np.asarray(aligned, np.float32).transpose(2, 0, 1) \
            / 127.5 - 1.0

    latents = []
    t0 = time.time()
    for lo in range(0, len(paths), batch):
        chunk_paths = paths[lo:lo + batch]
        n = len(chunk_paths)
        x = torch.from_numpy(np.stack([load(p) for p in chunk_paths])
                             ).to(dev)
        if n < batch:  # one batch shape for every call
            x = torch.cat([x, x[-1:].expand(batch - n, *x.shape[1:])])
        with torch.inference_mode():
            codes = psp.encode(x)
            latents.append(codes[:n].cpu().numpy())
            if save_images:
                recon = to_uint8_hwc(psp.decode(codes))
                for k, path in enumerate(chunk_paths):
                    Image.fromarray(recon[k], "RGB").save(os.path.join(
                        save_dir, "inversions", os.path.basename(path)))
        print(f"Inference took {time.time() - t0:.4f} seconds")
        t0 = time.time()

    w = np.concatenate(latents, axis=0)
    out = os.path.join(save_dir, "projected_w.npz")
    np.savez(out, w=w)
    print(f"saved {w.shape} to {out}")


if __name__ == "__main__":
    main()
