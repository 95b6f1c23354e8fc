"""Metric registry and runner (counterpart of
`stylemc_tpu/metrics/metric_main.py`).

`register_metric` / `is_valid_metric` / `calc_metric`, which returns an
EasyDict with the results, total_time and its string; the registered names
are the reference's (fid50k_full, kid50k_full, pr50k3_full, ppl2_wend,
is50k and the legacy fid50k, kid50k, pr50k3). The caller injects the
generator, the dataset-feature callable and the detectors through
`MetricOptions`, so every metric runs without the real Inception weights.

The generator's latents come from a torch.Generator seeded with
`opts.seed` (drawn on the host, so every device renders the same images);
the JAX package draws from `jax.random.PRNGKey(seed)`, so the two sample
different latents. `z_batches` and `ppl_batches` replace the default
streams, which is how a parity test hands both packages the same z and t.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..convert import as_float32
from ..device import resolve_device
from ..io.pickle_loader import EasyDict
from ..parallel.mesh import as_mesh, replicate, shard_batch
from .feature_stats import FeatureStats
from .scores import (fid_from_stats, kid_from_features,
                     inception_score_from_probs,
                     precision_recall_from_features)

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert callable(fn)
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict.keys())


@dataclasses.dataclass
class MetricOptions:
    """Everything a metric needs."""
    # generator bundle
    gen_params: Any = None
    gen_cfg: Any = None
    # feature detectors
    inception_features_fn: Optional[Callable] = None   # imgs_u8 → [N, 2048]
    inception_probs_fn: Optional[Callable] = None      # imgs_u8 → [N, P]
    lpips_params: Any = None                           # vgg lpips bundle
    # dataset side
    dataset_features_fn: Optional[Callable] = None     # (opts, max_items) → FeatureStats
    # run config
    num_gen: int = 50000
    batch_size: int = 16
    seed: int = 0
    progress_fn: Optional[Callable] = None
    # where the generator, the detectors' inputs and the KID/P&R products
    # run; None is cuda
    device: Any = None
    # zero-argument callables, each call a fresh iterator: of z batches
    # [batch_size, z_dim] for the generator, of (z0, z1, t) for PPL
    z_batches: Optional[Callable[[], Iterator]] = None
    ppl_batches: Optional[Callable[[], Iterator]] = None
    # a 1-axis parallel.DataMesh: each generator batch (and PPL's pairs)
    # splits over its devices, the images assembled on `device` in batch
    # order; batch_size must divide over it
    mesh: Any = None


def z_stream(opts: MetricOptions) -> Iterator[torch.Tensor]:
    """The default generator latents: N(0, 1) batches from a host
    torch.Generator seeded with opts.seed."""
    gen = torch.Generator().manual_seed(opts.seed)
    while True:
        yield torch.randn((opts.batch_size, opts.gen_cfg.z_dim),
                          generator=gen)


def _gen_images(opts: MetricOptions, n: int):
    """Yield uint8 NHWC batches of generated images, on the device."""
    from ..edit import to_u8_nhwc
    from ..models.stylegan2.generator import mapping, synthesis, w_to_s

    dev = resolve_device(opts.device)
    stream = opts.z_batches() if opts.z_batches is not None else \
        z_stream(opts)

    def render(gp, z):
        s = w_to_s(gp, opts.gen_cfg, mapping(gp, opts.gen_cfg, z))
        return to_u8_nhwc(synthesis(gp, opts.gen_cfg, s))

    mesh = as_mesh(opts.mesh)
    if mesh is not None:
        assert opts.batch_size % mesh.size == 0, \
            f"batch_size {opts.batch_size} must divide over {mesh.size} devices"
        params = replicate(opts.gen_params, mesh)
    done = 0
    while done < n:
        with torch.no_grad():
            z = as_float32(next(stream), dev)
            if mesh is None:
                imgs = render(opts.gen_params, z)
            else:
                imgs = torch.cat([render(params[d], zk).to(dev) for d, zk in
                                  zip(mesh.devices, shard_batch(mesh, z))])
        take = min(opts.batch_size, n - done)
        done += take
        if opts.progress_fn:
            opts.progress_fn(done, n)
        yield imgs if take == opts.batch_size else imgs[:take]


def compute_generator_features(opts: MetricOptions, feature_fn, n: int,
                               **stats_kwargs) -> FeatureStats:
    stats = FeatureStats(max_items=n, **stats_kwargs)
    for imgs in _gen_images(opts, n):
        with torch.no_grad():
            stats.append_multihost(feature_fn(imgs))
        if stats.is_full():
            break
    return stats


def calc_metric(metric: str, **kwargs) -> EasyDict:
    assert is_valid_metric(metric), f"unknown metric {metric}"
    opts = kwargs.pop("opts", None) or MetricOptions(**kwargs)
    start = time.time()
    results = _metric_dict[metric](opts)
    total_time = time.time() - start
    return EasyDict(
        results=EasyDict(results),
        metric=metric,
        total_time=total_time,
        total_time_str=f"{int(total_time // 60)}m {total_time % 60:.0f}s",
    )


# ------------------------------------------------------- registered metrics


def _fid(opts: MetricOptions, max_real, num_gen):
    real = opts.dataset_features_fn(opts, max_real)
    gen = compute_generator_features(opts, opts.inception_features_fn,
                                     num_gen, capture_mean_cov=True)
    mu_r, sig_r = real.get_mean_cov()
    mu_g, sig_g = gen.get_mean_cov()
    return fid_from_stats(mu_g, sig_g, mu_r, sig_r)


def _kid(opts: MetricOptions, max_real, num_gen, num_subsets=100,
         max_subset_size=1000):
    real = opts.dataset_features_fn(opts, max_real)
    gen = compute_generator_features(opts, opts.inception_features_fn,
                                     num_gen, capture_all=True)
    return kid_from_features(real.get_all(), gen.get_all(), num_subsets,
                             max_subset_size, device=opts.device)


def _pr(opts: MetricOptions, max_real):
    real = opts.dataset_features_fn(opts, max_real)
    gen = compute_generator_features(opts, opts.inception_features_fn,
                                     opts.num_gen, capture_all=True)
    return precision_recall_from_features(
        real.get_all(), gen.get_all(), nhood_size=3, device=opts.device)


@register_metric
def fid50k_full(opts):
    return {"fid50k_full": _fid(opts, max_real=None, num_gen=opts.num_gen)}


@register_metric
def kid50k_full(opts):
    return {"kid50k_full": _kid(opts, max_real=1000000, num_gen=opts.num_gen)}


@register_metric
def pr50k3_full(opts):
    precision, recall = _pr(opts, 200000)
    return {"pr50k3_full_precision": precision,
            "pr50k3_full_recall": recall}


@register_metric
def is50k(opts):
    gen = compute_generator_features(opts, opts.inception_probs_fn,
                                     opts.num_gen, capture_all=True)
    mean, std = inception_score_from_probs(gen.get_all(), num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}


@register_metric
def ppl2_wend(opts):
    from ..models.stylegan2.generator import mapping, synthesis, w_to_s
    from .ppl import compute_ppl

    def mapping_fn(gp, z):
        return mapping(gp, opts.gen_cfg, z)

    def synthesis_fn(gp, ws):
        return synthesis(gp, opts.gen_cfg, w_to_s(gp, opts.gen_cfg, ws))

    ppl = compute_ppl(mapping_fn, synthesis_fn, opts.lpips_params,
                      opts.gen_cfg.z_dim, num_samples=opts.num_gen,
                      epsilon=1e-4, space="w", sampling="end", crop=False,
                      batch_size=opts.batch_size, seed=opts.seed,
                      gen_params=opts.gen_params,
                      latents=opts.ppl_batches() if opts.ppl_batches
                      else None, device=opts.device, mesh=opts.mesh)
    return {"ppl2_wend": ppl}


# legacy variants


@register_metric
def fid50k(opts):
    return {"fid50k": _fid(opts, max_real=50000, num_gen=opts.num_gen)}


@register_metric
def kid50k(opts):
    return {"kid50k": _kid(opts, max_real=50000, num_gen=opts.num_gen)}


@register_metric
def pr50k3(opts):
    precision, recall = _pr(opts, 50000)
    return {"pr50k3_precision": precision, "pr50k3_recall": recall}

