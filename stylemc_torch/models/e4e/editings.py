"""Latent editing baselines over W+ codes: InterFaceGAN, GANSpace and SeFa
(counterpart of `stylemc_tpu/models/e4e/editings.py`). SeFa's eigen
decomposition stays in numpy (`np.linalg.eig`), as in the JAX package, so
the eigenvectors' signs agree."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def apply_interfacegan(latent, direction, factor: float = 1.0,
                       factor_range: Tuple[int, int] | None = None):
    """latent [N, S, 512] + f·direction, for f = factor or each f in
    range(*factor_range) (concatenated along N)."""
    if factor_range is not None:
        return torch.cat([latent + f * direction
                          for f in range(*factor_range)], dim=0)
    return latent + factor * direction


def ganspace_get_delta(pca: Dict, latent, idx: int, strength: float):
    """pca: {'mean', 'comp', 'std'}; latent: [S, 512]. The shift that moves
    row 0's coordinate along component idx to `strength` std."""
    def like(a):
        return torch.as_tensor(a, dtype=latent.dtype, device=latent.device)

    w_centered = latent - like(pca["mean"])
    lat_comp, lat_std = like(pca["comp"]), like(pca["std"])
    w_coord = torch.sum(w_centered[0].reshape(-1) * lat_comp[idx].reshape(-1)
                        ) / lat_std[idx]
    return (strength - w_coord) * lat_comp[idx] * lat_std[idx]


def apply_ganspace(latents, pca: Dict,
                   edit_directions: Sequence[Tuple[int, int, int, float]]):
    """latents [N, S, 512]; each (pca_idx, start, end, strength) edits rows
    start:end of every latent → [N·len(edit_directions), S, 512]."""
    edited = []
    for latent in latents:
        for pca_idx, start, end, strength in edit_directions:
            delta = ganspace_get_delta(pca, latent, pca_idx, strength)
            padded = torch.zeros_like(latent)
            padded[start:end] += delta.reshape(1, -1)
            edited.append(latent + padded)
    return torch.stack(edited)


def sefa_factorize(gen_params, layers="all"):
    """Closed-form factorization of the modulation weights: concatenate the
    chosen conv layers' affine weights (transposed, [w_dim, C]) in
    rosinality's layer order (b4's conv1, then conv0/conv1 per block),
    normalize columns, eigen-decompose W·Wᵀ → (conv indices, eigenvectors
    as rows, eigenvalues)."""
    syn = gen_params["synthesis"]
    block_names = sorted(syn.keys(), key=lambda b: int(b[1:]))
    affines = [_numpy(syn[block_names[0]]["conv1"]["affine"]["weight"]).T]
    all_convs = []
    for b in block_names[1:]:
        all_convs.extend([syn[b]["conv0"], syn[b]["conv1"]])
    if layers == "all":
        idxs = list(range(len(all_convs)))
    else:
        idxs = [l - 1 for l in layers if l != 0]
        if 0 not in layers:
            affines = []
    for i in idxs:
        affines.append(_numpy(all_convs[i]["affine"]["weight"]).T)
    weight = np.concatenate(affines, axis=1).astype(np.float32)
    weight = weight / np.linalg.norm(weight, axis=0, keepdims=True)
    eigen_values, eigen_vectors = np.linalg.eig(weight.dot(weight.T))
    return idxs, eigen_vectors.T.real, eigen_values.real


def apply_sefa(gen_params, latents, indices=(2, 3, 4, 5), semantics: int = 1,
               start_distance: float = -15.0, end_distance: float = 15.0,
               step: int = 11, num_samples: int = 1) -> torch.Tensor:
    """Sweep eigen-direction distances over the chosen layers →
    [semantics·num_samples·step, S, 512] on the CPU.

    The reference's quirk is kept: the boundary is added at the W+ rows
    equal to the conv indices, though conv i reads row i+1 — each edit
    lands one style row early."""
    layers, boundaries, _ = sefa_factorize(gen_params, list(indices))
    codes = _numpy(latents)
    distances = np.linspace(start_distance, end_distance, step)
    edited = []
    for sem_id in range(semantics):
        boundary = boundaries[sem_id:sem_id + 1]
        for sam_id in range(num_samples):
            code = codes[sam_id:sam_id + 1]
            for d in distances:
                tmp = code.copy()
                tmp[:, layers, :] += boundary * d
                edited.append(tmp)
    return torch.from_numpy(np.concatenate(edited, axis=0))
