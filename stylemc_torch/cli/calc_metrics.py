"""Evaluate GAN metrics on a generator checkpoint (counterpart of
`stylemc_tpu/cli/calc_metrics.py`): the same flags and the same JSON result
line per metric.

Dataset features come from an image directory (--data). The Inception
detector loads from --inception or STYLEMC_INCEPTION (a torchvision
inception_v3 state dict; pytorch-fid's pt_inception-2015-12-05 weights use
those names) and PPL's LPIPS-VGG from STYLEMC_LPIPS_VGG (a pickled tree of
numpy arrays, {"backbone": ..., "lin": ...}); --allow_random_init draws
both from fixed seeds instead. Detector variants (--detector_variant,
recorded in every result line): fid2015, the Inception-2015 TF graph the
reference's detector encodes; tv, torchvision's inception_v3, not
comparable to reference FIDs. Everything runs on --device (cuda unless
told otherwise); --data_parallel splits each generator batch (and PPL's
pairs) over the process's cards (`data_mesh(max_size=batch)`); on one card
or the CPU it runs as without it.

  python -m stylemc_torch.cli.calc_metrics --network ffhq.pkl \\
      --metrics fid50k_full,kid50k_full --data ffhq_images --num_gen 50000
"""

from __future__ import annotations

import json
import os

import click
import numpy as np
import torch

from ..io.numpy_pickle import load_numpy_pickle as load_lpips_pickle

INCEPTION_SEED = 0
LPIPS_SEED = 1


@click.command()
@click.option("--network", "network_pkl", required=True)
@click.option("--metrics", type=str, default="fid50k_full",
              help="comma-separated registered metric names")
@click.option("--data", "data_dir", type=str, default=None,
              help="real-image directory (required for FID/KID/PR)")
@click.option("--num_gen", type=int, default=50000)
@click.option("--batch", type=int, default=16)
@click.option("--inception", "inception_path", type=str, default=None)
@click.option("--detector_variant", type=click.Choice(["fid2015", "tv"]),
              default="fid2015",
              help="fid2015 = reference Inception-2015 TF graph "
                   "(FID comparable to the reference); tv = torchvision")
@click.option("--allow_random_init", is_flag=True, default=False)
@click.option("--data_parallel", is_flag=True, default=False,
              help="shard feature extraction over all local devices "
                   "(1-axis data mesh)")
@click.option("--device", default="cuda", show_default=True)
def main(network_pkl, metrics, data_dir, num_gen, batch, inception_path,
         detector_variant, allow_random_init, data_parallel, device):
    from PIL import Image

    from ..convert import params_from_numpy
    from ..data.images import make_dataset
    from ..device import disable_tf32, resolve_device
    from ..io import load_generator, load_state_dict_numpy
    from ..losses.lpips import init_lpips_params
    from ..metrics import MetricOptions, calc_metric, is_valid_metric
    from ..metrics import inception as inc
    from ..metrics.feature_stats import FeatureStats
    from ..parallel.mesh import cli_mesh

    dev = resolve_device(device)
    disable_tf32(dev)
    names = [name.strip() for name in metrics.split(",")]
    for name in names:
        if not is_valid_metric(name):
            raise click.BadParameter(f"unknown metric {name}",
                                     param_hint="--metrics")

    cfg, params = load_generator(network_pkl, device=dev)

    inception_path = inception_path or os.environ.get("STYLEMC_INCEPTION")
    if inception_path and os.path.exists(inception_path):
        inc_params = params_from_numpy(inc.params_from_torch_state(
            load_state_dict_numpy(inception_path)), dev)
    elif allow_random_init:
        inc_params = inc.init_inception_params(
            torch.Generator().manual_seed(INCEPTION_SEED), device=dev)
    else:
        raise FileNotFoundError(
            "set STYLEMC_INCEPTION to a torchvision inception_v3 state dict "
            "or pass --allow_random_init")

    def features_fn(x):
        return inc.inception_features(inc_params, x, variant=detector_variant)

    def probs_fn(x):
        return inc.inception_features(inc_params, x, return_logits=True,
                                      variant=detector_variant)

    def dataset_features_fn(opts, max_items):
        if not data_dir:
            raise click.UsageError("--data is required for this metric")
        stats = FeatureStats(capture_all=True, capture_mean_cov=True,
                             max_items=max_items)
        paths = make_dataset(data_dir)
        for lo in range(0, len(paths), batch):
            imgs = np.stack([
                np.asarray(Image.open(p).convert("RGB"), np.uint8)
                for p in paths[lo:lo + batch]])
            with torch.no_grad():
                stats.append(features_fn(torch.from_numpy(imgs).to(dev)))
            if stats.is_full():
                break
        return stats

    lpips_params = None
    lpips_path = os.environ.get("STYLEMC_LPIPS_VGG")
    if lpips_path and os.path.exists(lpips_path):
        lpips_params = params_from_numpy(load_lpips_pickle(lpips_path), dev)
    elif allow_random_init:
        lpips_params = init_lpips_params(
            torch.Generator().manual_seed(LPIPS_SEED), "vgg", device=dev)

    mesh = cli_mesh(data_parallel, batch, dev)
    if mesh is not None:
        print(f"data-parallel feature extraction over {mesh.size} devices")

    opts = MetricOptions(
        gen_params=params, gen_cfg=cfg,
        inception_features_fn=features_fn, inception_probs_fn=probs_fn,
        dataset_features_fn=dataset_features_fn,
        lpips_params=lpips_params, num_gen=num_gen, batch_size=batch,
        device=dev, mesh=mesh)

    for name in names:
        out = calc_metric(name, opts=opts)
        print(json.dumps({"metric": name, **out.results,
                          "detector": detector_variant,
                          "total_time": out.total_time}))


if __name__ == "__main__":
    main()
