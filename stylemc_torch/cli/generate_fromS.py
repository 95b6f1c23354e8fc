"""Apply a saved S-space direction or latent mapper and render
before/after pairs.

Reads `direction_{prompt}.npz` (key 's') or, with --use_mapper 1,
`mapper_{prompt}.pth` from --outdir and writes one [orig | edited] JPEG
per item, `{prompt}_{i:03d}.jpeg` with spaces in the prompt turned into
underscores. A mapper gives each item its own direction (--use_whitelist 1
zeroes |δ| < 0.1 and the stoplist's ids). --use_blending 1 renders --batch
items at a time through `serve.BatchEditor` with DeepLab feature blending
(the face parser from STYLEMC_DEEPLAB). --projected-w renders G(w) per item
instead;
--power_sweep / --from_video write a GIF per item.

  python -m stylemc_torch.cli.generate_fromS --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompt "a smiling face"
  python -m stylemc_torch.cli.generate_fromS --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompt "a smiling face" \
      --use_mapper 1 --use_whitelist 1 --use_blending 1
"""

from __future__ import annotations

import os
import time

import click
import numpy as np
import torch


@click.command()
@click.option("--network", "network_pkl", required=True,
              help="Network pickle filename (for original img)")
@click.option("--network2", "network2_pkl", required=False, default=None,
              help="Network2 pickle filename (for generation)")
@click.option("--noise-mode", type=click.Choice(["const", "random", "none"]),
              default="const", show_default=True)
@click.option("--projected-w", "projected_w", type=str, default=None,
              help="Render full G(w) per image instead of S-space editing")
@click.option("--s_input", type=str, default=None, help="Styles npz")
@click.option("--use_mapper", type=int, default=0)
@click.option("--n", type=int, default=99999, help="generate first n results")
@click.option("--outdir", type=str, required=True)
@click.option("--text_prompt", type=str, required=True)
@click.option("--change_power", type=float, default=2.0, show_default=True)
@click.option("--mapper_neg_slope", type=float, default=0.01)
@click.option("--use_blending", type=int, default=0)
@click.option("--use_whitelist", type=int, default=0)
@click.option("--power_sweep", type=str, default=None,
              help="'start:end:steps' — render a change_power sweep per item "
                   "and save an animated GIF")
@click.option("--from_video", is_flag=True, default=False,
              help="shorthand for --power_sweep '0:<change_power>:25'")
@click.option("--batch", type=int, default=8, help="items per render call")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, network2_pkl, noise_mode, projected_w, s_input,
         use_mapper, n, outdir, text_prompt, change_power, mapper_neg_slope,
         use_blending, use_whitelist, power_sweep, from_video, batch, device):
    from PIL import Image

    from ..edit import (apply_edit_batch, mapper_direction,
                        mapper_directions_batched, to_uint8_hwc)
    from ..io import load_generator
    from ..models.stylegan2.generator import synthesis, w_to_s

    print(f'Loading networks from "{network_pkl}"...')
    cfg, params = load_generator(network_pkl, device=device)
    gen2 = None
    if network2_pkl and network2_pkl != network_pkl:
        print(f'Loading networks from "{network2_pkl}"...')
        cfg2, params2 = load_generator(network2_pkl, device=device)
        gen2 = (params2, cfg2)
    os.makedirs(outdir, exist_ok=True)

    if projected_w is not None:
        ws = np.load(projected_w)["w"].astype(np.float32)
        with torch.inference_mode():
            styles = w_to_s(params, cfg, torch.from_numpy(ws).to(device))
            imgs = synthesis(params, cfg, styles, noise_mode=noise_mode)
        for idx, img in enumerate(to_uint8_hwc(imgs)):
            Image.fromarray(img, "RGB").save(f"{outdir}/proj{idx:02d}.png")
        return

    t1 = time.time()
    styles = torch.from_numpy(
        np.load(s_input)["s"][:n].astype(np.float32)).to(device)
    print(f"loaded {len(styles)} styles")
    prompt_tag = text_prompt.replace(" ", "_")
    mapper = direction = None
    if use_mapper:
        from ..models.mapper import load_mapper

        mapper = load_mapper(f"{outdir}/mapper_{prompt_tag}.pth",
                             device=device)
    else:
        direction = torch.from_numpy(np.load(
            f"{outdir}/direction_{prompt_tag}.npz")["s"].astype(np.float32)
        ).to(device)

    segmenter = None
    if use_blending:
        print("Using blending... Loading segmentation model")
        from ..models.deeplab import default_segmenter

        segmenter = default_segmenter(device=device)

    def direction_for(i):
        if mapper is not None:
            return mapper_direction(mapper, styles[i],
                                    neg_slope=mapper_neg_slope,
                                    use_whitelist=bool(use_whitelist))
        return direction

    n_items = styles.shape[0]

    if from_video and not power_sweep:
        power_sweep = f"0:{change_power}:25"
    if power_sweep:
        start, end, steps = power_sweep.split(":")
        powers = np.linspace(float(start), float(end), int(steps))
        for i in range(n_items):
            d = direction_for(i)
            frames = []
            for p_w in powers:
                _, edited = apply_edit_batch(params, cfg, styles[i:i + 1],
                                             d, float(p_w),
                                             noise_mode=noise_mode, gen2=gen2)
                frames.append(Image.fromarray(to_uint8_hwc(edited)[0], "RGB"))
            gif = f"{outdir}/{prompt_tag}_{i:03d}_sweep.gif"
            frames[0].save(gif, save_all=True, append_images=frames[1:],
                           duration=120, loop=0)
        print(f"saved {n_items} sweep GIFs")
        print("time passed:", time.time() - t1)
        return

    def save(i, orig_u8, edited_u8):
        Image.fromarray(np.concatenate([orig_u8, edited_u8], axis=1),
                        "RGB").save(f"{outdir}/{prompt_tag}_{i:03d}.jpeg",
                                    quality=95)

    if use_blending:
        from ..serve import BatchEditor

        editor = BatchEditor(
            cfg, params, mapper_params=mapper,
            mapper_neg_slope=mapper_neg_slope,
            mapper_whitelist=bool(use_whitelist), max_batch=batch,
            noise_mode=noise_mode, device=device)
        if mapper is None:
            editor.add_direction(text_prompt, direction.cpu().numpy())
        editor.attach_segmenter(segmenter, edit_generator=gen2)
        for lo in range(0, n_items, batch):
            pairs = editor.edit_styles(
                styles[lo:lo + batch], change_power, pairs=True,
                direction_name=None if mapper is not None else text_prompt,
                prompt=text_prompt)
            w = pairs.shape[2] // 2
            for j, pair in enumerate(pairs):
                save(lo + j, pair[:, :w], pair[:, w:])
        print("time passed:", time.time() - t1)
        return

    for lo in range(0, n_items, batch):
        hi = min(lo + batch, n_items)
        chunk = styles[lo:hi]
        dirs = direction if mapper is None else mapper_directions_batched(
            mapper, chunk, neg_slope=mapper_neg_slope,
            use_whitelist=bool(use_whitelist))
        orig, edited = apply_edit_batch(params, cfg, chunk, dirs,
                                        change_power, noise_mode=noise_mode,
                                        gen2=gen2)
        orig_u8, edited_u8 = to_uint8_hwc(orig), to_uint8_hwc(edited)
        for j in range(hi - lo):
            save(lo + j, orig_u8[j], edited_u8[j])
    print("time passed:", time.time() - t1)


if __name__ == "__main__":
    main()
