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

With a mesh (`parallel.DataMesh`) each step's batch rows split over its
devices: each shard's loss and the gradient of its rows' mean to the 20
weights on its device, combined by the shard's share of the rows (summed
over the process group when one is up), then one Adam step.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.mapper import as_mapper, init_mapper_params, mapper_apply
from ..models.stylegan2.generator import GeneratorConfig
from ..parallel.mesh import DataMesh, as_mesh, data_parallel, tree_to
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


def make_mapper_edit(neg_slope: float, template=None) -> Callable:
    """The mapper's edit, an `edit_fn` of `make_loss_fn`:
    styles2[:, TRAINABLE] = styles[:, TRAINABLE] + mapper(styles[:,
    TRAINABLE]). The mapper is a Mapper, or a {name: tensor} dict of its
    weights applied through `template`'s structure."""
    def edit_fn(mapper, styles):
        x = styles[:, TRAINABLE]
        delta = torch.func.functional_call(template, mapper, (x, neg_slope)) \
            if isinstance(mapper, dict) else mapper_apply(mapper, x, neg_slope)
        return styles + assemble_direction(delta)
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


def _dp_adam_step(loss_fns, bank, mesh: DataMesh, opt, mapper, idx, lr):
    """`_adam_step` with the batch rows `idx` split over the mesh: each
    shard takes the mapper's weights on its device; the combined
    gradients feed one Adam step."""
    styles, id_all, clip_all, refs = bank
    names = [n for n, _ in mapper.named_parameters()]
    params = [p for _, p in mapper.named_parameters()]
    keys: List[str] = []

    def shard(dev, rows):
        i = idx[rows]
        leaves = [p.detach().to(dev).requires_grad_(True) for p in params]
        loss, aux = loss_fns[dev](
            dict(zip(names, leaves)), styles[i].to(dev), id_all[i].to(dev),
            tuple(c[i].to(dev) for c in clip_all),
            None if refs is None else tuple(t[i].to(dev) for t in refs))
        grads = torch.autograd.grad(loss, leaves)
        keys[:] = list(aux)
        return [loss.detach(), *grads] + [torch.as_tensor(aux[k]).detach()
                                          for k in keys]

    out = data_parallel(mesh, idx.shape[0], shard, params[0].device)
    loss, grads, aux = out[0], out[1:1 + len(params)], out[1 + len(params):]
    for group in opt.param_groups:
        group["lr"] = lr
    with torch.no_grad():
        grad_norm = sum(torch.linalg.vector_norm(g) for g in grads)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None
    return mapper, loss, dict(zip(keys, aux)), grad_norm


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
    in find_direction. mesh: a 1-axis `parallel.DataMesh` over which each
    step's batch splits (mtc.batch_size must divide over it)."""
    mesh = as_mesh(mesh)
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

    edit_fn = make_mapper_edit(mtc.mapper_neg_slope, template=mapper)
    loss_fn = make_loss_fn(gen_params, gen_cfg, bundles, arcface_params, mtc,
                           edit_fn=edit_fn, edit_gen=gen2,
                           mobilenet_params=mobilenet_params)
    opt = torch.optim.Adam(mapper.parameters(), lr=mtc.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    bank = (styles_array, id_feats_orig_all, clip_feats_orig_all, refs)
    if mesh is None:
        step = functools.partial(_adam_step, loss_fn, bank, opt)
    else:
        models = (gen_params, bundles, arcface_params, gen2, mobilenet_params)

        def build(d):
            gp, bs, arc, g2, mob = tree_to(models, d)
            return make_loss_fn(gp, gen_cfg, bs, arc, mtc, edit_fn=edit_fn,
                                edit_gen=g2, mobilenet_params=mob)

        step = functools.partial(
            _dp_adam_step, {d: loss_fn if d == dev else build(d)
                            for d in mesh.distinct}, bank, mesh, opt)

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
