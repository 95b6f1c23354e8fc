"""Apply a saved S-space direction and render before/after pairs.

Reads `direction_{prompt}.npz` (key 's') from --outdir and writes one
[orig | edited] JPEG per item, `{prompt}_{i:03d}.jpeg` with spaces in the
prompt turned into underscores. --projected-w renders G(w) per item
instead; --power_sweep / --from_video write a GIF per item. Mapper
directions and DeepLab blending are not ported yet.

  python -m stylemc_torch.cli.generate_fromS --network ffhq.pkl \
      --s_input out/input.npz --outdir out --text_prompt "a smiling face"
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
@click.option("--n", type=int, default=99999, help="generate first n results")
@click.option("--outdir", type=str, required=True)
@click.option("--text_prompt", type=str, required=True)
@click.option("--change_power", type=float, default=2.0, show_default=True)
@click.option("--power_sweep", type=str, default=None,
              help="'start:end:steps' — render a change_power sweep per item "
                   "and save an animated GIF")
@click.option("--from_video", is_flag=True, default=False,
              help="shorthand for --power_sweep '0:<change_power>:25'")
@click.option("--batch", type=int, default=8, help="items per render call")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, network2_pkl, noise_mode, projected_w, s_input, n,
         outdir, text_prompt, change_power, power_sweep, from_video, batch,
         device):
    from PIL import Image

    from ..edit import apply_edit_batch, to_uint8_hwc
    from ..io import load_generator
    from ..models.stylegan2.generator import inference_cfg, synthesis, w_to_s

    print(f'Loading networks from "{network_pkl}"...')
    cfg, params = load_generator(network_pkl, device=device)
    cfg = inference_cfg(cfg)  # render-only CLI
    gen2 = None
    if network2_pkl and network2_pkl != network_pkl:
        print(f'Loading networks from "{network2_pkl}"...')
        cfg2, params2 = load_generator(network2_pkl, device=device)
        gen2 = (params2, inference_cfg(cfg2))
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
    direction = torch.from_numpy(np.load(
        f"{outdir}/direction_{prompt_tag}.npz")["s"].astype(np.float32)
    ).to(device)
    n_items = styles.shape[0]

    if from_video and not power_sweep:
        power_sweep = f"0:{change_power}:25"
    if power_sweep:
        start, end, steps = power_sweep.split(":")
        powers = np.linspace(float(start), float(end), int(steps))
        for i in range(n_items):
            frames = []
            for p_w in powers:
                _, edited = apply_edit_batch(params, cfg, styles[i:i + 1],
                                             direction, float(p_w),
                                             noise_mode=noise_mode, gen2=gen2)
                frames.append(Image.fromarray(to_uint8_hwc(edited)[0], "RGB"))
            gif = f"{outdir}/{prompt_tag}_{i:03d}_sweep.gif"
            frames[0].save(gif, save_all=True, append_images=frames[1:],
                           duration=120, loop=0)
        print(f"saved {n_items} sweep GIFs")
        print("time passed:", time.time() - t1)
        return

    for lo in range(0, n_items, batch):
        hi = min(lo + batch, n_items)
        orig, edited = apply_edit_batch(params, cfg, styles[lo:hi], direction,
                                        change_power, noise_mode=noise_mode,
                                        gen2=gen2)
        orig_u8, edited_u8 = to_uint8_hwc(orig), to_uint8_hwc(edited)
        for j in range(hi - lo):
            Image.fromarray(np.concatenate([orig_u8[j], edited_u8[j]], axis=1),
                            "RGB").save(f"{outdir}/{prompt_tag}_{lo + j:03d}.jpeg",
                                        quality=95)
    print("time passed:", time.time() - t1)


if __name__ == "__main__":
    main()
