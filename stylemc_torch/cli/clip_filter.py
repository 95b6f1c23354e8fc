"""CLIP-based dataset filtering and balancing: classify rendered images
against '|'-separated prompts with CLIP ViT-B/32, keep the items whose
best prompt is --keep_class, and subset the styles npz to them.

  python -m stylemc_torch.cli.clip_filter --images_dir out/ \
      --s_input input.npz --prompts "a photo of a man|a photo of a woman" \
      --keep_class 1 --out_file out/women.npz
"""

from __future__ import annotations

import os

import click
import numpy as np
import torch


def classify_images(params, cfg, text_features, images_u8):
    """uint8 [N, H, W, 3] → each image's best prompt [N]: CLIP's
    preprocessing (bicubic short-side resize, centre crop, normalise) and
    one batched image encode on the device of `params`."""
    from ..models.clip import encode_image
    from ..models.clip.preprocess import (center_crop, clip_mean_std,
                                          resize_short_side)

    dev = text_features.device
    x = torch.as_tensor(images_u8, device=dev).permute(0, 3, 1, 2).float()
    x = center_crop(resize_short_side(x / 255.0, cfg.image_resolution),
                    cfg.image_resolution)
    mean, std = clip_mean_std(x)
    f = encode_image(params, cfg, (x - mean) / std)
    f = f / f.norm(dim=-1, keepdim=True)
    return (f @ text_features.T).argmax(dim=-1)


@click.command()
@click.option("--images_dir", type=str, required=True)
@click.option("--s_input", type=str, default=None,
              help="styles npz to subset alongside the images")
@click.option("--prompts", type=str, required=True,
              help="'|'-separated class prompts, e.g. "
                   "'a photo of a man|a photo of a woman'")
@click.option("--keep_class", type=int, required=True,
              help="index of the prompt class to keep")
@click.option("--out_file", type=str, required=True,
              help="output npz (filtered styles + kept indices)")
@click.option("--batch", type=int, default=16)
@click.option("--allow_random_init", is_flag=True, default=False)
@click.option("--device", default="cuda", show_default=True)
def main(images_dir, s_input, prompts, keep_class, out_file, batch,
         allow_random_init, device):
    from PIL import Image

    from ..data.images import make_dataset
    from ..device import disable_tf32, resolve_device
    from ..models.clip import encode_text, tokenize
    from ..utils import model_zoo

    dev = resolve_device(device)
    disable_tf32(dev)
    clip_models, tokenizer = model_zoo.load_clip_models(
        "small", allow_random_init=allow_random_init, device=dev)
    cfg, params = clip_models["ViT-B/32"]

    prompt_list = [p.strip() for p in prompts.split("|")]
    paths = make_dataset(images_dir)
    keep_idx = []
    with torch.inference_mode():
        tf = encode_text(params, cfg, tokenize(prompt_list,
                                               tokenizer=tokenizer))
        tf = tf / tf.norm(dim=-1, keepdim=True)
        for lo in range(0, len(paths), batch):
            chunk = paths[lo:lo + batch]
            imgs = np.stack([np.asarray(Image.open(p).convert("RGB"),
                                        np.uint8) for p in chunk])
            pred = classify_images(params, cfg, tf, imgs).cpu().numpy()
            keep_idx.extend(lo + i for i in range(len(chunk))
                            if pred[i] == keep_class)
    print(f"kept {len(keep_idx)}/{len(paths)} images for class "
          f"{prompt_list[keep_class]!r}")

    out = {"indices": np.asarray(keep_idx, np.int64),
           "paths": np.asarray([paths[i] for i in keep_idx])}
    if s_input:
        styles = np.load(s_input)["s"]
        out["s"] = styles[np.asarray(keep_idx, np.int64)]
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    np.savez(out_file, **out)
    print(f"saved {out_file}")


if __name__ == "__main__":
    main()
