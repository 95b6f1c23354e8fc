"""Sample W latents from seeds: per seed np.random.RandomState(seed)
.randn(1, z_dim) → mapping with truncation → npz {'w': [N, num_ws, 512]}.

  python -m stylemc_torch.cli.generate_w --network ffhq.pkl --seeds 1-8 \
      --trunc 0.7 --out_file out/projected_w.npz
"""

from __future__ import annotations

import os

import click
import numpy as np
import torch

from ..utils.misc import num_range


@click.command()
@click.option("--network", "network_pkl", required=True,
              help="Network pickle filename")
@click.option("--seeds", type=num_range, help="List of random seeds",
              required=True)
@click.option("--trunc", "truncation_psi", type=float, default=1.0,
              show_default=True, help="Truncation psi")
@click.option("--out_file", type=str, default="encoder4editing/projected_w.npz",
              help="out file path")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, seeds, truncation_psi, out_file, device):
    from ..io import load_generator
    from ..models.stylegan2.generator import mapping

    print(f'Loading networks from "{network_pkl}"...')
    cfg, params = load_generator(network_pkl, device=device)
    zs = np.concatenate([np.random.RandomState(s).randn(1, cfg.z_dim)
                         for s in seeds]).astype(np.float32)
    with torch.inference_mode():
        ws = mapping(params, cfg, torch.from_numpy(zs).to(device),
                     truncation_psi=truncation_psi).cpu().numpy()
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    np.savez(out_file, w=ws)
    print(f"saved {ws.shape} to {out_file}")


if __name__ == "__main__":
    main()
