"""Global S-space direction optimization, the StyleMC core (counterpart of
`stylemc_tpu/train/find_direction.py`).

SGD over a trainable Δs restricted to S rows [2,3,5,6,8,9,11,12], cosine
learning rate, loss = id_coef·ArcFace + clip_coef·CLIP-directional
(+0.5·ViT-B/16 when clip_type='double') + l2_coef·MSE(styles2, styles),
partial-resolution synthesis up to until_k.

As in the JAX package, the original images depend only on the fixed seed
styles, so their ArcFace and CLIP features are computed once
(`precompute_original_features`, under no_grad) and each step runs one
synthesis and one forward of each perception model. Every model parameter
is frozen, so autograd builds only the Δs path; on the card the ToRGB
chain's upsample runs B1 forward and B2 backward
(`ops/kernels/upfirdn2d.py`).

The batch order is the JAX package's: one `np.random.RandomState(seed)`
draw per step. The learning rate is computed on the host in float64 and
applied as float32, as the JAX step does. The landmarks term is a
logging-only metric that carries no gradient; it is not ported (ROADMAP
A11) and reads 0.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..losses.clip_loss import make_text_direction
from ..losses.clip_loss_nada import NADATextAnchors, preprocess_nada
from ..losses.id_loss import extract_feats
from ..models.clip import encode_image, tokenize, unprocess
from ..models.stylegan2.generator import (
    N_STYLE_CHANNELS, S_TRAINABLE_SPACE_CHANNELS, STYLE_DIM, GeneratorConfig,
    synthesis)

TRAINABLE = list(S_TRAINABLE_SPACE_CHANNELS)


@dataclasses.dataclass
class FindDirectionConfig:
    """The JAX package's fields and defaults (the reference CLI's)."""
    text_prompt: str = "a photo of a face of a feminine woman with no makeup"
    negative_text_prompt: str = "a photo of a face of a masculine man"
    resolution: int = 256
    batch_size: int = 4
    learning_rate: float = 1.5
    n_epochs: int = 4
    identity_loss_coef: float = 0.6
    landmarks_loss_coef: float = 25.0
    # the differentiable landmarks loss is not ported (ROADMAP A11)
    landmarks_in_graph: bool = False
    l2_reg_coef: float = 0.1
    clip_loss_coef: float = 1.0
    clip_type: str = "double"          # 'small' | 'large' | 'double'
    clip_loss_type: str = "default"    # 'default' | 'nada' | 'nada_global'
    noise_mode: str = "const"
    seed: int = 0
    # non-default ArcFace bottleneck layout (tests); None = IR-SE-50
    arcface_layout: Optional[Any] = None
    # accepted for the JAX package's interface; in torch both run the same
    # per-step loop and give the same numbers
    split_step: bool = False
    steps_per_dispatch: int = 1
    # 'float32', or 'bfloat16' to run CLIP and ArcFace in bf16
    perception_dtype: str = "float32"
    lr_schedule: str = "cosine"        # 'cosine' | 'constant'


def until_k_for_resolution(resolution: int) -> int:
    """Block index for partial-resolution synthesis ({256: 6, 512: 7,
    1024: 8})."""
    return int(np.log2(resolution)) - 2


def cosine_lr(base_lr: float, cur_iteration: int, total_iterations: int
              ) -> float:
    return float(np.cos(np.pi * cur_iteration / total_iterations)
                 * base_lr * 0.5 + base_lr * 0.5)


def schedule_lr(fdc: FindDirectionConfig, cur_iteration: int,
                total_iterations: int) -> float:
    """LR for step `cur_iteration` under fdc.lr_schedule."""
    if fdc.lr_schedule == "constant":
        return float(fdc.learning_rate)
    if fdc.lr_schedule != "cosine":
        raise ValueError(f"lr_schedule {fdc.lr_schedule!r} "
                         "(cosine | constant)")
    return cosine_lr(fdc.learning_rate, cur_iteration, total_iterations)


@dataclasses.dataclass
class CLIPBundle:
    cfg: Any
    params: Any
    text_direction: Optional[torch.Tensor] = None     # StyleMC loss
    nada_anchors: Optional[NADATextAnchors] = None    # NADA losses
    weight: float = 1.0


def make_clip_bundles(fdc: FindDirectionConfig, clip_models: Dict[str, Tuple],
                      tokenizer=None) -> List[CLIPBundle]:
    """clip_models: {'ViT-B/32': (cfg, params), ...} → the 1-2 weighted
    bundles with their text anchors."""
    if fdc.clip_type == "double":
        names_weights = [("ViT-B/32", 1.0), ("ViT-B/16", 0.5)]
    elif fdc.clip_type == "large":
        names_weights = [("ViT-B/16", 1.0)]
    else:
        names_weights = [("ViT-B/32", 1.0)]

    bundles = []
    with torch.no_grad():
        for name, weight in names_weights:
            cfg, params = clip_models[name]
            b = CLIPBundle(cfg=cfg, params=params, weight=weight)
            if fdc.clip_loss_type in ("nada", "nada_global"):
                b.nada_anchors = NADATextAnchors.create(
                    params, cfg, fdc.negative_text_prompt, fdc.text_prompt,
                    tokenizer=tokenizer)
            else:
                b.text_direction = make_text_direction(
                    params, cfg,
                    tokenize([fdc.text_prompt], tokenizer=tokenizer),
                    tokenize([fdc.negative_text_prompt], tokenizer=tokenizer))
            bundles.append(b)
    return bundles


def _perception_dtype(fdc: FindDirectionConfig) -> torch.dtype:
    return getattr(torch, fdc.perception_dtype)


def _clip_image_features(bundle: CLIPBundle, img, clip_loss_type: str,
                         dtype: torch.dtype = torch.float32):
    size = bundle.cfg.image_resolution
    if clip_loss_type in ("nada", "nada_global"):
        x = preprocess_nada(img, size)
    else:
        x = unprocess(img, size)
    return encode_image(bundle.params, bundle.cfg, x.to(dtype)).float()


def _id_features(arcface_params, img, fdc: FindDirectionConfig):
    return extract_feats(arcface_params, img.to(_perception_dtype(fdc)),
                         fdc.arcface_layout).float()


def precompute_original_features(gen_params, gen_cfg: GeneratorConfig,
                                 styles_array: torch.Tensor,
                                 bundles: List[CLIPBundle], arcface_params,
                                 fdc: FindDirectionConfig, chunk: int = 8):
    """Original-image ArcFace and CLIP features for every item, computed
    once, in chunks of `chunk` (the last chunk padded with its last row, as
    the JAX package pads it)."""
    until_k = until_k_for_resolution(fdc.resolution)
    dtype = _perception_dtype(fdc)
    n = styles_array.shape[0]
    id_out, clip_out = [], [[] for _ in bundles]
    with torch.no_grad():
        for i in range(0, n, chunk):
            batch = styles_array[i:i + chunk]
            keep = batch.shape[0]
            if keep < chunk:
                batch = torch.cat(
                    [batch, batch[-1:].expand(chunk - keep, *batch.shape[1:])])
            img = synthesis(gen_params, gen_cfg, batch, until_k=until_k,
                            noise_mode=fdc.noise_mode)
            id_out.append(_id_features(arcface_params, img, fdc)[:keep])
            for j, b in enumerate(bundles):
                clip_out[j].append(_clip_image_features(
                    b, img, fdc.clip_loss_type, dtype)[:keep])
    return torch.cat(id_out), tuple(torch.cat(c) for c in clip_out)


def _clip_term_from_img(bundle: CLIPBundle, clip_loss_type: str, img, orig_f,
                        dtype: torch.dtype = torch.float32):
    """One bundle's CLIP term given the rendered image and the cached
    original-image features (un-normalized encode_image outputs)."""
    f_tgt = _clip_image_features(bundle, img, clip_loss_type, dtype)

    def normalize(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    if clip_loss_type == "nada_global":
        t_n = bundle.nada_anchors.target_text_features
        logit_scale = torch.exp(bundle.params["logit_scale"])
        return torch.mean(1.0 - logit_scale * (normalize(f_tgt) @ t_n.T)
                          / 100.0)
    if clip_loss_type == "nada":
        edit = normalize(f_tgt) - normalize(orig_f)
        edit = edit / torch.clamp(
            torch.linalg.vector_norm(edit, dim=-1, keepdim=True), min=1e-6)
        cos = torch.sum(edit * bundle.nada_anchors.target_direction, dim=-1)
        return torch.mean(1.0 - cos)
    # StyleMC: normalize(E(tgt) − E(src)) against the text direction; the
    # norm is clamped so a zero edit gives loss 1, not 0/0
    edit = f_tgt - orig_f
    edit = edit / torch.clamp(
        torch.linalg.vector_norm(edit, dim=-1, keepdim=True), min=1e-6)
    cos = torch.sum(edit * bundle.text_direction.to(edit.dtype), dim=-1)
    return torch.mean(1.0 - cos)


def assemble_direction(delta_s: torch.Tensor) -> torch.Tensor:
    """[1, 8, 512] trainable rows → full [1, 26, 512] direction
    (differentiable in delta_s)."""
    rows = torch.tensor(TRAINABLE, device=delta_s.device)
    direction = delta_s.new_zeros((1, N_STYLE_CHANNELS, STYLE_DIM))
    return direction.index_copy(1, rows, delta_s)


def make_loss_fn(gen_params, gen_cfg: GeneratorConfig,
                 bundles: List[CLIPBundle], arcface_params,
                 fdc: FindDirectionConfig,
                 edit_fn: Optional[Callable] = None):
    """loss(trainable, styles, id_feats_orig, clip_feats_orig) →
    (loss, aux). edit_fn(trainable, styles) → styles2; by default the
    global-direction edit (Δs rows added to the trainable rows)."""
    if fdc.landmarks_in_graph:
        raise NotImplementedError(
            "landmarks_in_graph is not ported yet (ROADMAP A11)")
    until_k = until_k_for_resolution(fdc.resolution)
    dtype = _perception_dtype(fdc)
    rows = torch.tensor(TRAINABLE)

    if edit_fn is None:
        def edit_fn(delta_s, styles):
            return styles + assemble_direction(delta_s)

    def loss_fn(trainable, styles, id_feats_orig, clip_feats_orig):
        styles2 = edit_fn(trainable, styles)
        img = synthesis(gen_params, gen_cfg, styles2, until_k=until_k,
                        noise_mode=fdc.noise_mode)

        id_f = _id_features(arcface_params, img, fdc)
        identity_loss = torch.mean(1.0 - torch.sum(id_f * id_feats_orig,
                                                   dim=1))
        identity_loss = identity_loss * fdc.identity_loss_coef

        clip_loss = 0.0
        for b, orig_f in zip(bundles, clip_feats_orig):
            clip_loss = clip_loss + b.weight * _clip_term_from_img(
                b, fdc.clip_loss_type, img, orig_f, dtype)
        clip_loss = clip_loss * fdc.clip_loss_coef

        r = rows.to(styles.device)
        l2 = fdc.l2_reg_coef * torch.mean(torch.square(
            styles2.index_select(1, r) - styles.index_select(1, r)))

        loss = identity_loss + clip_loss + l2
        aux = {"clip_loss": clip_loss, "identity_loss": identity_loss,
               "l2_loss": l2}
        return loss, aux

    return loss_fn


def _freeze(tree) -> None:
    """Mark every tensor leaf of a params tree as needing no gradient."""
    if isinstance(tree, dict):
        for v in tree.values():
            _freeze(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _freeze(v)
    elif isinstance(tree, torch.Tensor):
        tree.requires_grad_(False)


def find_direction(gen_params, gen_cfg: GeneratorConfig, styles_array,
                   clip_models: Dict[str, Tuple], arcface_params,
                   fdc: FindDirectionConfig,
                   tokenizer=None,
                   resume_direction: Optional[np.ndarray] = None,
                   callback: Optional[Callable] = None):
    """Run the optimization on the device that holds `gen_params`. Returns
    (direction [1, 26, 512] tensor on that device, info).

    styles_array: [n_items, 26, 512]; clip_models: {'ViT-B/32': (cfg,
    params)}. callback(iteration, loss, aux, lr, grad_norm, direction
    [1, 26, 512] numpy) every 10 iterations and at the last.

    Without `resume_direction`, Δs starts at N(0, 1)·1e-3 drawn from a CPU
    `torch.Generator` seeded with fdc.seed (the JAX package draws it from
    `jax.random`, which torch cannot reproduce).
    """
    dev = gen_params["mapping"]["w_avg"].device
    for tree in (gen_params, arcface_params,
                 [p for _, p in clip_models.values()]):
        _freeze(tree)
    if not isinstance(styles_array, torch.Tensor):
        styles_array = torch.tensor(np.asarray(styles_array, np.float32))
    styles_array = styles_array.to(dev, torch.float32)
    n_items = styles_array.shape[0]
    bundles = make_clip_bundles(fdc, clip_models, tokenizer)

    id_feats_orig_all, clip_feats_orig_all = precompute_original_features(
        gen_params, gen_cfg, styles_array, bundles, arcface_params, fdc)

    if resume_direction is not None:
        delta_s = torch.as_tensor(
            np.asarray(resume_direction, np.float32)[:, TRAINABLE]).to(dev)
    else:
        gen = torch.Generator().manual_seed(fdc.seed)
        delta_s = (torch.randn((1, len(TRAINABLE), STYLE_DIM), generator=gen)
                   * 1e-3).to(dev)

    loss_fn = make_loss_fn(gen_params, gen_cfg, bundles, arcface_params, fdc)

    num_batches = math.ceil(n_items / fdc.batch_size)
    total_iterations = num_batches * fdc.n_epochs

    rng = np.random.RandomState(fdc.seed)
    cur_iteration = 0
    t0 = time.time()
    first_step_done = None
    history = []
    for _ in range(fdc.n_epochs):
        for _ in range(num_batches):
            cur_iteration += 1
            lr = schedule_lr(fdc, cur_iteration, total_iterations)
            idx = torch.as_tensor(
                rng.randint(0, n_items, size=fdc.batch_size)).to(dev)
            styles = styles_array[idx]
            id_f = id_feats_orig_all[idx]
            clip_f = tuple(c[idx] for c in clip_feats_orig_all)

            delta_s.requires_grad_(True)
            loss, aux = loss_fn(delta_s, styles, id_f, clip_f)
            grads, = torch.autograd.grad(loss, delta_s)
            with torch.no_grad():
                # optax.sgd: params + (−lr)·g, with lr rounded to float32
                delta_s = delta_s.detach() + float(np.float32(-lr)) * grads
                grad_norm = torch.linalg.vector_norm(grads.reshape(-1))
            loss = loss.detach()
            aux = {k: torch.as_tensor(v).detach() for k, v in aux.items()}

            if cur_iteration == 1:
                # one drain separates the first step (kernel builds, cuDNN
                # and cuBLAS set-up) from the steady steps
                float(loss)
                first_step_done = time.time()
            if callback is not None and (cur_iteration % 10 == 0
                                         or cur_iteration == total_iterations):
                aux_out = {k: float(v) for k, v in aux.items()}
                aux_out.setdefault("landmarks_loss", 0.0)
                callback(cur_iteration, float(loss), aux_out, lr,
                         float(grad_norm),
                         assemble_direction(delta_s).cpu().numpy())
            history.append(loss)  # kept on the device: no sync per step

    direction = assemble_direction(delta_s.detach())
    flat_history = torch.stack(history).cpu().numpy() if history else \
        np.zeros((0,), np.float32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    info = {"history": [float(x) for x in flat_history],
            "time": elapsed, "iterations": cur_iteration}
    if first_step_done is not None and cur_iteration > 1:
        info["first_step_time"] = first_step_done - t0
        info["steady_ms_per_step"] = (
            1e3 * (elapsed - (first_step_done - t0)) / (cur_iteration - 1))
    return direction, info
