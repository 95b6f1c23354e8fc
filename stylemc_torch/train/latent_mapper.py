"""Latent-mapper training (counterpart of `stylemc_tpu/train/latent_mapper.py`).

Adam (betas 0.9/0.999, eps 1e-8) over the Mapper's 20 weights at the
cosine learning rate, set before each update; the loss stack is
find_direction's (`make_loss_fn`), with the mapper's edit
styles2[:, TRAINABLE] = styles[:, TRAINABLE] + mapper(styles[:, TRAINABLE])
and, optionally, a second generator that renders the edited image. torch's
Adam and optax's compute the same update (bias correction in both). The
batch stream is find_direction's: one `np.random.RandomState(seed)` draw
per step. Every model but the mapper is frozen, so the backward pass runs
B2 through the ToRGB chain of the edited render.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.mapper import as_mapper, init_mapper_params, mapper_apply
from ..models.stylegan2.generator import GeneratorConfig
from .find_direction import (
    FindDirectionConfig, _freeze, _sgd_loop, _styles_on, assemble_direction,
    make_clip_bundles, make_loss_fn, precompute_original_features,
    prepare_landmarks_refs, TRAINABLE)


@dataclasses.dataclass
class MapperTrainConfig(FindDirectionConfig):
    """The reference CLI's defaults: Adam lr 5e-4, resolution 512, batch 2,
    10 epochs, id 0.3, landmarks 0.0, l2 0.8, clip 2.0."""
    resolution: int = 512
    batch_size: int = 2
    learning_rate: float = 0.0005
    n_epochs: int = 10
    identity_loss_coef: float = 0.3
    landmarks_loss_coef: float = 0.0
    l2_reg_coef: float = 0.8
    clip_loss_coef: float = 2.0
    mapper_neg_slope: float = 0.01


def make_mapper_edit(neg_slope: float) -> Callable:
    """The mapper's edit, an `edit_fn` of `make_loss_fn`:
    styles2[:, TRAINABLE] = styles[:, TRAINABLE] + mapper(styles[:,
    TRAINABLE])."""
    def edit_fn(mapper, styles):
        return styles + assemble_direction(
            mapper_apply(mapper, styles[:, TRAINABLE], neg_slope))
    return edit_fn


def _adam_step(loss_fn, bank, opt, mapper, idx, lr):
    """One Adam step on the batch rows `idx` of bank = (styles, id feats,
    clip feats, landmarks refs or None). → (mapper, loss, aux, grad norm:
    the sum of the per-weight L2 norms, as the JAX trainer reports it)."""
    styles, id_all, clip_all, refs = bank
    refs = None if refs is None else tuple(t[idx] for t in refs)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(mapper, styles[idx], id_all[idx],
                        tuple(c[idx] for c in clip_all), refs)
    loss.backward()
    with torch.no_grad():
        grad_norm = sum(torch.linalg.vector_norm(p.grad)
                        for p in mapper.parameters())
    opt.step()
    return (mapper, loss.detach(),
            {k: torch.as_tensor(v).detach() for k, v in aux.items()},
            grad_norm)


def train_latent_mapper(gen_params, gen_cfg: GeneratorConfig, styles_array,
                        clip_models: Dict[str, Tuple], arcface_params,
                        mtc: MapperTrainConfig,
                        tokenizer=None,
                        mesh=None,
                        gen2: Optional[Tuple] = None,
                        resume_params=None,
                        callback: Optional[Callable] = None,
                        landmarker=None):
    """Train a mapper on the device that holds `gen_params`. Returns
    (mapper, info).

    gen2: a second generator's (params, cfg) that renders the edited image.
    resume_params: a Mapper or a reference state dict to start from; else
    `init_mapper_params` from a CPU generator seeded with mtc.seed.
    callback(it, loss, aux, lr, grad_norm, mapper) every 10 iterations.
    mtc.landmarks_in_graph needs `landmarker` (cv.landmarks.Landmarker), as
    in find_direction."""
    if mesh is not None:
        raise ValueError("multi-device mapper training is not ported "
                         "(ROADMAP A17); pass mesh=None")
    if mtc.landmarks_in_graph and landmarker is None:
        raise ValueError("landmarks_in_graph needs a landmarker "
                         "(MTCNN and MobileNet weights)")
    dev = gen_params["mapping"]["w_avg"].device
    mobilenet_params = landmarker.params if mtc.landmarks_in_graph else None
    for tree in (gen_params, arcface_params, mobilenet_params,
                 gen2[0] if gen2 is not None else None,
                 [p for _, p in clip_models.values()]):
        _freeze(tree)
    styles_array = _styles_on(styles_array, dev)
    bundles = make_clip_bundles(mtc, clip_models, tokenizer)

    id_feats_orig_all, clip_feats_orig_all = precompute_original_features(
        gen_params, gen_cfg, styles_array, bundles, arcface_params, mtc)
    refs = None
    if mtc.landmarks_in_graph:
        refs = prepare_landmarks_refs(gen_params, gen_cfg, styles_array, mtc,
                                      landmarker)

    if resume_params is not None:
        # a copy: the caller's mapper is not trained in place
        mapper = copy.deepcopy(as_mapper(resume_params, dev))
    else:
        mapper = init_mapper_params(torch.Generator().manual_seed(mtc.seed),
                                    device=dev)
    mapper.requires_grad_(True)

    loss_fn = make_loss_fn(gen_params, gen_cfg, bundles, arcface_params, mtc,
                           edit_fn=make_mapper_edit(mtc.mapper_neg_slope),
                           edit_gen=gen2,
                           mobilenet_params=mobilenet_params)
    opt = torch.optim.Adam(mapper.parameters(), lr=mtc.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    step = functools.partial(
        _adam_step, loss_fn,
        (styles_array, id_feats_orig_all, clip_feats_orig_all, refs), opt)

    def after_step(it, total, lr, idx, m, loss, aux, grad_norm):
        if callback is not None and it % 10 == 0:
            callback(it, float(loss), {k: float(v) for k, v in aux.items()},
                     lr, float(grad_norm), m)

    # the JAX trainer's schedule is always the cosine one
    mapper, hist, info = _sgd_loop(
        mapper, step, styles_array.shape[0],
        dataclasses.replace(mtc, lr_schedule="cosine"), after_step,
        device=dev)
    info["history"] = [float(x) for x in hist]
    return mapper, info
