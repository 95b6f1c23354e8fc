"""StyleMC's global-direction training in plain PyTorch (the published
find_direction.py): SGD on the eight trainable S-space rows with a cosine
learning rate, loss = 0.6·ArcFace identity + CLIP-directional (ViT-B/32,
plus 0.5·ViT-B/16 for clip_type 'double') + 0.1·L2, the originals'
features fixed. `follow` runs its first steps from the same start and
batch order as the CLI, in float32, one prompt or several at once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import perception, stylegan2

TRAINABLE = (2, 3, 5, 6, 8, 9, 11, 12)
CLIP_WEIGHTS = (("ViT-B/32", 1.0), ("ViT-B/16", 0.5))


def cosine_lr(base: float, it: int, total: int) -> float:
    return math.cos(math.pi * it / total) * base * 0.5 + base * 0.5


def initial_delta(fd_seed: int) -> torch.Tensor:
    """The CLI's start: N(0, 1)·1e-3 [1, 8, 512] from a CPU torch
    generator seeded with its seed."""
    gen = torch.Generator().manual_seed(fd_seed)
    return torch.randn((1, len(TRAINABLE), 512), generator=gen) * 1e-3


def batch_order(fd_seed: int, n_items: int, batch: int, steps: int
                ) -> List[np.ndarray]:
    rng = np.random.RandomState(fd_seed)
    return [rng.randint(0, n_items, size=batch) for _ in range(steps)]


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def text_direction(models, tokens_pos, tokens_neg, name):
    p, c = models["clip"][name]
    return _normalize(perception.clip_text(p, c, tokens_pos)
                      - perception.clip_text(p, c, tokens_neg))


def image_features(models, img):
    """(identity features, {clip name: image features}) of [-1, 1] images."""
    arc_p, layout = models["arcface"]
    ident = perception.arcface(arc_p, layout, img)
    feats = {}
    for name, _ in CLIP_WEIGHTS:
        p, c = models["clip"][name]
        feats[name] = perception.clip_image(
            p, c, perception.clip_preprocess(img, c["image_resolution"]))
    return ident, feats


def loss_of(models, g, styles, delta, orig, text_dirs, coefs, until_k):
    """styles [B, 26, 512], delta [P, 8, 512], orig = (identity [B, E],
    {name: [B, E]}), text_dirs {name: [P, E]} → loss [P]."""
    p_count = delta.shape[0]
    full = torch.zeros((p_count, 26, 512), device=delta.device)
    full[:, list(TRAINABLE)] = delta
    styles2 = styles[None] + full[:, None]                 # [P, B, 26, 512]
    img = stylegan2.synthesis(models["generator"], g,
                              styles2.reshape(-1, 26, 512), until_k)
    ident, feats = image_features(models, img)
    b = styles.shape[0]
    ident = ident.reshape(p_count, b, -1)
    id_loss = (1.0 - (ident * orig[0][None]).sum(-1)).mean(-1)
    clip_loss = 0.0
    for name, weight in CLIP_WEIGHTS:
        edit = feats[name].reshape(p_count, b, -1) - orig[1][name][None]
        edit = edit / torch.linalg.vector_norm(
            edit, dim=-1, keepdim=True).clamp(min=1e-6)
        cos = (edit * text_dirs[name][:, None]).sum(-1)
        clip_loss = clip_loss + weight * (1.0 - cos).mean(-1)
    # the trainable rows of styles2 - styles are delta in every batch row
    l2 = delta.square().mean(dim=(-2, -1))
    return (coefs["identity"] * id_loss + coefs["clip"] * clip_loss
            + coefs["l2"] * l2)


def follow(models, g, styles_all: torch.Tensor,
           tokens: Dict[str, torch.Tensor], job: Dict, steps: int,
           until_k: int, fault: Optional[str] = None,
           start: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The first `steps` SGD steps of a job. tokens: {'pos': [P, 77],
    'neg': [P, 77]}; job: the traffic's training parameters. `fault`
    plants one of the faults the check must catch: 'unchanged' (each step
    returns its state), 'half_batch' (the loss over the first half of each
    batch's rows). `start` [P or 1, 8, 512]: the resumed rows, else the
    CLI's fresh start. → {'delta': [P, 8, 512] after the steps, 'losses':
    [steps, P]}."""
    dev = styles_all.device
    n_items, batch = styles_all.shape[0], job["batch_size"]
    total = math.ceil(n_items / batch) * job["n_epochs"]
    coefs = {"identity": job["identity_loss_coef"],
             "clip": job["clip_loss_coef"], "l2": job["l2_reg_coef"]}
    p_count = tokens["pos"].shape[0]
    with torch.no_grad():
        text_dirs = {name: text_direction(models, tokens["pos"],
                                          tokens["neg"], name)
                     for name, _ in CLIP_WEIGHTS}
    start = initial_delta(job["fd_seed"]) if start is None else start
    delta = start.to(dev).expand(p_count, -1, -1).clone()
    order = batch_order(job["fd_seed"], n_items, batch, steps)
    losses = []
    for it, idx in enumerate(order, start=1):
        if fault == "half_batch":
            idx = idx[:len(idx) // 2]
        idx = torch.as_tensor(idx, device=dev)
        styles = styles_all[idx]
        with torch.no_grad():
            orig = image_features(models, stylegan2.synthesis(
                models["generator"], g, styles, until_k))
        delta = delta.detach().requires_grad_(True)
        loss = loss_of(models, g, styles, delta, orig, text_dirs, coefs,
                       until_k)
        grad, = torch.autograd.grad(loss.sum(), delta)
        lr = np.float32(-cosine_lr(job["learning_rate"], it, total))
        if fault != "unchanged":
            with torch.no_grad():
                delta = delta + float(lr) * grad
        losses.append(loss.detach())
    return {"delta": delta.detach(), "losses": torch.stack(losses)}


def styles_of(models, g, zs: torch.Tensor, psi: float) -> torch.Tensor:
    return stylegan2.w_to_s(models["generator"], g,
                            stylegan2.mapping(models["generator"], g, zs, psi))


def tokens_to(ids: Sequence[Sequence[int]], device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)
