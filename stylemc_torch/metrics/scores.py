"""GAN metric scores: FID, KID, Inception Score, Precision & Recall
(counterpart of `stylemc_tpu/metrics/scores.py`).

FID's matrix square root runs on the host (scipy), as in the JAX package.
KID's polynomial kernels and P&R's pairwise distances are plain products,
run as torch products on a device (the CPU being one): KID's in float64,
P&R's in float32 as the JAX package's numpy does. Random subsets draw from
the same numpy `RandomState`, so the same features give the same subsets.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import scipy.linalg
import torch

from ..device import DeviceLike, resolve_device


def fid_from_stats(mu_gen, sigma_gen, mu_real, sigma_real) -> float:
    """||mu_g − mu_r||² + Tr(C_g + C_r − 2(C_g C_r)^½)."""
    m = np.square(mu_gen - mu_real).sum()
    # with fewer samples than features the covariance product is singular
    # and sqrtm warns; the reference ignores sqrtm's error estimate too
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    dist = m + np.trace(sigma_gen + sigma_real - s * 2)
    return float(np.real(dist))


def _kid_subset_term(x, y, n: int, m: int):
    a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
    b = (x @ y.T / n + 1) ** 3
    return (a.sum() - a.trace()) / (m - 1) - b.sum() * 2 / m


def kid_from_features(real_features: np.ndarray, gen_features: np.ndarray,
                      num_subsets: int = 100, max_subset_size: int = 1000,
                      seed: int = 0, device: DeviceLike = None) -> float:
    """Unbiased polynomial-kernel MMD over `num_subsets` random subsets,
    its kernels in float64 on `device` (None is cuda)."""
    dev = resolve_device(device)
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]),
            max_subset_size)
    rng = np.random.RandomState(seed)
    gen = torch.as_tensor(gen_features, device=dev, dtype=torch.float64)
    real = torch.as_tensor(real_features, device=dev, dtype=torch.float64)
    t = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(num_subsets):
        gi = rng.choice(gen_features.shape[0], m, replace=False)
        ri = rng.choice(real_features.shape[0], m, replace=False)
        t += _kid_subset_term(gen[torch.as_tensor(gi, device=dev)],
                              real[torch.as_tensor(ri, device=dev)], n, m)
    return float(t / num_subsets / m)


def inception_score_from_probs(probs: np.ndarray,
                               num_splits: int = 10) -> Tuple[float, float]:
    """exp(mean KL(p(y|x) ‖ p(y))) over `num_splits` splits; probs: softmax
    outputs [N, 1008/1000]."""
    scores = []
    num_gen = probs.shape[0]
    # fewer samples than splits would leave empty splits: clamp
    num_splits = max(1, min(num_splits, num_gen))
    for i in range(num_splits):
        part = probs[i * num_gen // num_splits:(i + 1) * num_gen // num_splits]
        kl = part * (np.log(part + 1e-12) -
                     np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        kl = np.mean(np.sum(kl, axis=1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def compute_distances_batched(row_features: torch.Tensor,
                              col_features: torch.Tensor,
                              col_batch_size: int = 10000) -> torch.Tensor:
    """Batched pairwise L2 distances [rows, cols], on the inputs' device."""
    aa = row_features.square().sum(dim=1, keepdim=True)
    out = []
    for lo in range(0, col_features.shape[0], col_batch_size):
        b = col_features[lo:lo + col_batch_size]
        bb = b.square().sum(dim=1, keepdim=True)
        out.append(torch.clamp(aa + bb.T - 2.0 * (row_features @ b.T),
                               min=0.0).sqrt())
    return torch.cat(out, dim=1)


def precision_recall_from_features(real_features: np.ndarray,
                                   gen_features: np.ndarray,
                                   nhood_size: int = 3,
                                   row_batch_size: int = 10000,
                                   col_batch_size: int = 10000,
                                   device: DeviceLike = None
                                   ) -> Tuple[float, float]:
    """Improved P&R (Kynkäänniemi et al.): a sample is covered if it falls
    within the k-NN radius of some manifold point. The distances, radii
    and coverage are float32 products on `device` (None is cuda)."""
    dev = resolve_device(device)
    real_features = torch.as_tensor(real_features, device=dev,
                                    dtype=torch.float32)
    gen_features = torch.as_tensor(gen_features, device=dev,
                                   dtype=torch.float32)
    results = {}
    for name, manifold, probes in (
            ("precision", real_features, gen_features),
            ("recall", gen_features, real_features)):
        # the nhood_size-th neighbour; self (distance 0) is in the sort
        kth = torch.cat([
            torch.kthvalue(compute_distances_batched(
                manifold[lo:lo + row_batch_size], manifold, col_batch_size),
                nhood_size + 1, dim=1).values
            for lo in range(0, manifold.shape[0], row_batch_size)])
        pred = torch.cat([
            (compute_distances_batched(probes[lo:lo + row_batch_size],
                                       manifold, col_batch_size)
             <= kth[None, :]).any(dim=1)
            for lo in range(0, probes.shape[0], row_batch_size)])
        results[name] = float(pred.double().mean())
    return results["precision"], results["recall"]
