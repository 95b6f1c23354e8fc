"""Convert W latents to packed S-space styles: load the w npz, apply each
block's affines (each torgb reuses the next conv's w), save npz
{'s': [N, 26, 512]}.

  python -m stylemc_torch.cli.w_s_converter --network ffhq.pkl \
      --projected-w out/projected_w.npz --out_file out/input.npz
"""

from __future__ import annotations

import os

import click
import numpy as np
import torch


@click.command()
@click.option("--network", "network_pkl", required=True,
              help="Network pickle filename")
@click.option("--projected-w", "projected_w", type=str, required=True,
              help="Projection result file")
@click.option("--out_file", type=str, default="out/input.npz",
              help="out file path")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, projected_w, out_file, device):
    from ..io import load_generator
    from ..models.stylegan2.generator import w_to_s

    print(f'Loading networks from "{network_pkl}"...')
    cfg, params = load_generator(network_pkl, device=device)
    ws = np.load(projected_w)["w"].astype(np.float32)
    with torch.inference_mode():
        styles = w_to_s(params, cfg, torch.from_numpy(ws).to(device))
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    np.savez(out_file, s=styles.cpu().numpy())
    print(f"saved {tuple(styles.shape)} to {out_file}")


if __name__ == "__main__":
    main()
