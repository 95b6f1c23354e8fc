"""Perceptual Path Length (counterpart of `stylemc_tpu/metrics/ppl.py`).

Pairs of latents `epsilon` apart along a lerp in W (or a slerp in Z),
sampling 'end' or 'full'; both endpoints rendered; an optional face crop
(rows 3c:7c, columns 2c:6c, c = H/8); mean-pooled down to 256; the per-pair
LPIPS-VGG distance divided by ε²; the mean over the [1 %, 99 %] quantiles.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..convert import as_float32
from ..device import DeviceLike, resolve_device
from ..losses.lpips import lpips_distances
from ..parallel.mesh import as_mesh, replicate, shard_batch


def slerp(a, b, t):
    """Spherical interpolation of unit vectors: inputs are normalised, and
    so is the result, as in the reference."""
    a_n = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b_n = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    d = torch.sum(a_n * b_n, dim=-1, keepdim=True)
    p = t * torch.arccos(torch.clamp(d, -1.0, 1.0))
    c = b_n - d * a_n
    c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    out = a_n * torch.cos(p) + c * torch.sin(p)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def ppl_latents(z_dim: int, batch_size: int, sampling: str = "end",
                seed: int = 0) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The default latent stream: (z0, z1, t) batches drawn on the host
    from a torch.Generator seeded with `seed` (so every device gets the
    same pairs); t = 0 for 'end' sampling, U(0, 1) for 'full'."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        z0 = torch.randn((batch_size, z_dim), generator=gen)
        z1 = torch.randn((batch_size, z_dim), generator=gen)
        t = torch.rand((batch_size,), generator=gen) if sampling == "full" \
            else torch.zeros((batch_size,))
        yield z0, z1, t


def compute_ppl(mapping_fn: Callable, synthesis_fn: Callable,
                lpips_params, z_dim: int,
                num_samples: int = 2000, epsilon: float = 1e-4,
                space: str = "w", sampling: str = "end",
                crop: bool = False, batch_size: int = 8,
                seed: int = 0, gen_params=None,
                latents: Optional[Iterable] = None,
                device: DeviceLike = None, mesh=None) -> float:
    """mapping_fn(gen_params, z) → ws; synthesis_fn(gen_params, ws) → images
    in [-1, 1]. `latents` is a stream of (z0, z1, t) batches (by default
    `ppl_latents(z_dim, batch_size, sampling, seed)`); the pairs run on
    `device` (cuda unless the caller says otherwise). mesh: a 1-axis
    `parallel.DataMesh` over which each batch of pairs splits (batch_size
    must divide over it), the weights replicated per device."""
    dev = resolve_device(device)
    mesh = as_mesh(mesh)
    if mesh is not None:
        assert batch_size % mesh.size == 0, (batch_size, mesh.size)
        replicas = replicate((gen_params, lpips_params), mesh)
    if latents is None:
        latents = ppl_latents(z_dim, batch_size, sampling, seed)
    stream = iter(latents)

    def pair_distance(z0, z1, t, gen_params=gen_params,
                      lpips_params=lpips_params):
        if space == "w":
            w0 = mapping_fn(gen_params, z0)
            w1 = mapping_fn(gen_params, z1)
            wt0 = w0 + (w1 - w0) * t[:, None, None]
            wt1 = w0 + (w1 - w0) * (t[:, None, None] + epsilon)
        else:
            wt0 = mapping_fn(gen_params, slerp(z0, z1, t[:, None]))
            wt1 = mapping_fn(gen_params, slerp(z0, z1, t[:, None] + epsilon))
        img0 = synthesis_fn(gen_params, wt0)
        img1 = synthesis_fn(gen_params, wt1)
        if crop:
            c = img0.shape[2] // 8
            img0 = img0[:, :, c * 3:c * 7, c * 2:c * 6]
            img1 = img1[:, :, c * 3:c * 7, c * 2:c * 6]
        factor = img0.shape[2] // 256
        if factor > 1:
            n, ch, h, w = img0.shape
            img0 = img0.reshape(n, ch, h // factor, factor,
                                w // factor, factor).mean(dim=(3, 5))
            img1 = img1.reshape(n, ch, h // factor, factor,
                                w // factor, factor).mean(dim=(3, 5))
        return lpips_distances(lpips_params, img0, img1, "vgg") / epsilon ** 2

    dists = []
    with torch.no_grad():
        for _ in range(0, num_samples, batch_size):
            z0, z1, t = (as_float32(v, dev) for v in next(stream))
            if mesh is None:
                dists.append(pair_distance(z0, z1, t).cpu().numpy())
                continue
            for d, (a, b, c) in zip(mesh.devices,
                                    zip(*shard_batch(mesh, z0, z1, t))):
                dists.append(pair_distance(a, b, c, *replicas[d])
                             .cpu().numpy())
    d = np.concatenate(dists)[:num_samples]
    # the reference keeps the [1 %, 99 %] quantiles
    lo_q = np.percentile(d, 1, method="lower")
    hi_q = np.percentile(d, 99, method="higher")
    return float(np.extract(np.logical_and(d >= lo_q, d <= hi_q), d).mean())
