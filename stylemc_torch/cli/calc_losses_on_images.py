"""LPIPS or L2 between two image directories (counterpart of
`stylemc_tpu/cli/calc_losses_on_images.py`): images of --data_path are
paired with the --gt_path images of the same file name, read at 256² in
batches of --batch, and one JSON line reports the mean, the standard
deviation and the count of the values. As in the JAX package, an lpips
value is a batch's mean (n counts batches) and an l2 value one image's
(n counts images). LPIPS loads from STYLEMC_LPIPS_<TYPE>, a pickled tree
of numpy arrays; --allow_random_init draws it from a fixed seed.

  python -m stylemc_torch.cli.calc_losses_on_images --mode lpips \\
      --data_path out/e4e/inversions --gt_path photos
"""

from __future__ import annotations

import json
import os

import click
import numpy as np
import torch

LPIPS_SEED = 0


@click.command()
@click.option("--mode", type=click.Choice(["lpips", "l2"]), default="lpips")
@click.option("--data_path", type=str, required=True, help="generated images")
@click.option("--gt_path", type=str, required=True, help="ground-truth images")
@click.option("--batch", type=int, default=4)
@click.option("--lpips_type", default="alex")
@click.option("--allow_random_init", is_flag=True, default=False)
@click.option("--device", default="cuda", show_default=True)
def main(mode, data_path, gt_path, batch, lpips_type, allow_random_init,
         device):
    from ..convert import params_from_numpy
    from ..data.images import load_image, make_dataset
    from ..device import disable_tf32, resolve_device
    from ..io.numpy_pickle import load_numpy_pickle
    from ..losses.lpips import init_lpips_params, lpips_loss

    dev = resolve_device(device)
    disable_tf32(dev)
    gen_paths = make_dataset(data_path)
    gt_by_name = {os.path.basename(p): p for p in make_dataset(gt_path)}
    pairs = [(p, gt_by_name[os.path.basename(p)]) for p in gen_paths
             if os.path.basename(p) in gt_by_name]
    print(f"{len(pairs)} matched pairs")

    lp = None
    if mode == "lpips":
        path = os.environ.get("STYLEMC_LPIPS_" + lpips_type.upper())
        if path and os.path.exists(path):
            lp = params_from_numpy(load_numpy_pickle(path), dev)
        elif allow_random_init:
            lp = init_lpips_params(torch.Generator().manual_seed(LPIPS_SEED),
                                   lpips_type, device=dev)
        else:
            raise FileNotFoundError(
                f"set STYLEMC_LPIPS_{lpips_type.upper()} or pass "
                "--allow_random_init")

    def score(a, b):
        if mode == "l2":
            return torch.mean((a - b).square(), dim=(1, 2, 3))
        return lpips_loss(lp, a, b, lpips_type)

    vals = []
    for lo in range(0, len(pairs), batch):
        chunk = pairs[lo:lo + batch]
        a = torch.from_numpy(np.stack([load_image(p, 256) for p, _ in chunk]))
        b = torch.from_numpy(np.stack([load_image(q, 256) for _, q in chunk]))
        with torch.no_grad():
            v = score(a.to(dev), b.to(dev)).cpu().numpy()
        vals.extend(np.atleast_1d(v).tolist())
    print(json.dumps({"mode": mode, "mean": float(np.mean(vals)),
                      "std": float(np.std(vals)), "n": len(vals)}))


if __name__ == "__main__":
    main()
