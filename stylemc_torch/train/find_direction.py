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
applied as float32, as the JAX step does.

The landmarks term, as in the JAX package: by default a logging-only
metric (`make_landmarks_metric_fn`: render, MTCNN, MobileNet on the host
pipeline) that carries no gradient, as in the reference; with
`landmarks_in_graph` a differentiable term, from MTCNN boxes found once on
the originals (`prepare_landmarks_refs`), a differentiable crop and the
MobileNet landmarker in the step.

`DirectionEngine` sweeps prompts over one precompute. Its `optimize_batch`
trains P prompts at once by folding the prompt axis into the image batch:
each prompt's Δs edits its own copy of the batch's styles, one synthesis
call renders all P·B images, CLIP and ArcFace take them together, and the
loss is the sum of the P per-prompt losses, so each prompt's Δs gets its
own gradient (the prompts share no parameter).

Data parallelism (`parallel.mesh`), as the JAX package's mesh paths:
`find_direction(mesh=)` splits each step's batch rows over the mesh
devices (`_dp_step`): each shard's loss and Δs gradient on its device,
combined into the full batch's values by the shard's share of the rows
(every term of the loss is a mean over the batch's images), summed over
the process group when one is up. `optimize_batch(mesh=)` shards the
prompts over a 1-axis mesh, or over 'prompt' with each group's batch over
'data' on a 2-axis one.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..losses.clip_loss import make_text_direction
from ..losses.clip_loss_nada import NADATextAnchors, preprocess_nada
from ..losses.id_loss import extract_feats
from ..losses.landmarks_loss import landmarks_loss
from ..models.clip import encode_image, tokenize, unprocess
from ..models.stylegan2.generator import (
    N_STYLE_CHANNELS, S_TRAINABLE_SPACE_CHANNELS, STYLE_DIM, GeneratorConfig,
    synthesis)
from ..parallel.mesh import DataMesh, as_mesh, data_parallel, tree_to

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
    # backpropagate the landmarks loss (see the module docstring); False
    # keeps the reference's logging-only term
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


def _clip_names_weights(fdc: FindDirectionConfig):
    if fdc.clip_type == "double":
        return [("ViT-B/32", 1.0), ("ViT-B/16", 0.5)]
    if fdc.clip_type == "large":
        return [("ViT-B/16", 1.0)]
    return [("ViT-B/32", 1.0)]


def make_clip_bundles(fdc: FindDirectionConfig, clip_models: Dict[str, Tuple],
                      tokenizer=None) -> List[CLIPBundle]:
    """clip_models: {'ViT-B/32': (cfg, params), ...} → the 1-2 weighted
    bundles with their text anchors."""
    bundles = []
    with torch.no_grad():
        for name, weight in _clip_names_weights(fdc):
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


def _anchors(bundle: CLIPBundle) -> Dict[str, torch.Tensor]:
    """The bundle's own prompt anchors, keyed as `DirectionEngine` passes
    them."""
    if bundle.nada_anchors is not None:
        return {"target_direction": bundle.nada_anchors.target_direction,
                "target_text_features":
                    bundle.nada_anchors.target_text_features}
    return {"text_direction": bundle.text_direction}


def _clip_term(bundle: CLIPBundle, clip_loss_type: str, f_tgt, orig_f,
               text: Optional[Dict[str, torch.Tensor]] = None):
    """One bundle's CLIP term from the edited images' features f_tgt
    [..., B, E] and the cached original features orig_f [B, E]
    (un-normalised encode_image outputs); the mean over B, one value per
    leading index. `text` holds the prompt anchors ([..., 1, E]); None
    means the bundle's own."""
    text = text if text is not None else _anchors(bundle)

    def normalize(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    if clip_loss_type == "nada_global":
        t_n = text["target_text_features"]
        logit_scale = torch.exp(bundle.params["logit_scale"])
        return torch.mean(1.0 - logit_scale * (
            normalize(f_tgt) @ t_n.transpose(-1, -2)) / 100.0, dim=(-2, -1))
    if clip_loss_type == "nada":
        edit = normalize(f_tgt) - normalize(orig_f)
        edit = edit / torch.clamp(
            torch.linalg.vector_norm(edit, dim=-1, keepdim=True), min=1e-6)
        cos = torch.sum(edit * text["target_direction"], dim=-1)
        return torch.mean(1.0 - cos, dim=-1)
    # StyleMC: normalize(E(tgt) − E(src)) against the text direction; the
    # norm is clamped so a zero edit gives loss 1, not 0/0
    edit = f_tgt - orig_f
    edit = edit / torch.clamp(
        torch.linalg.vector_norm(edit, dim=-1, keepdim=True), min=1e-6)
    cos = torch.sum(edit * text["text_direction"].to(edit.dtype), dim=-1)
    return torch.mean(1.0 - cos, dim=-1)


def assemble_direction(delta_s: torch.Tensor) -> torch.Tensor:
    """[..., 8, 512] trainable rows → full [..., 26, 512] direction
    (differentiable in delta_s)."""
    rows = torch.tensor(TRAINABLE, device=delta_s.device)
    direction = delta_s.new_zeros(delta_s.shape[:-2]
                                  + (N_STYLE_CHANNELS, STYLE_DIM))
    return direction.index_copy(delta_s.dim() - 2, rows, delta_s)


def crop_landmarks(mobilenet_params, img: torch.Tensor, boxes: torch.Tensor
                   ) -> torch.Tensor:
    """The landmarks of each image's box, crop-normalised [B, 68, 2]: the
    differentiable crop of img ([-1, 1]) to 224², as uint8/255 would read
    it, through the MobileNet landmarker."""
    from ..cv.landmarks import normalize_crop
    from ..models.mobilenet import mobilenet_gdconv_apply
    from ..ops.image import crop_resize_bilinear

    crop = crop_resize_bilinear(img, boxes)
    x = normalize_crop(crop * 0.5 + 128.0 / 255.0)
    return mobilenet_gdconv_apply(mobilenet_params, x).reshape(
        x.shape[0], -1, 2)


def make_loss_fn(gen_params, gen_cfg: GeneratorConfig,
                 bundles: List[CLIPBundle], arcface_params,
                 fdc: FindDirectionConfig,
                 edit_fn: Optional[Callable] = None,
                 edit_gen: Optional[Tuple] = None,
                 mobilenet_params=None):
    """loss(trainable, styles, id_feats_orig, clip_feats_orig,
    landmarks_refs=None, text_dirs=None) → (loss, aux).

    edit_fn(trainable, styles) → styles2; by default the global-direction
    edit (Δs rows added to the trainable rows); the mapper trainer passes
    its own. edit_gen: an optional second generator's (params, cfg) that
    renders the edited image (the two-generator domain-transfer mode); the
    originals' features still come from the first. A trainable of [P, 1, 8,
    512] edits P copies of the batch: styles2 [P, B, 26, 512] render in one
    synthesis call, and loss and aux hold one value per prompt. text_dirs
    (one anchor dict per bundle, `DirectionEngine._text_dirs`) replaces the
    bundles' own anchors. With fdc.landmarks_in_graph, landmarks_refs is
    the batch rows' (boxes [B, 4], crop-normalised landmarks [B, 68, 2])
    from `prepare_landmarks_refs`, and mobilenet_params the landmarker's
    weights."""
    until_k = until_k_for_resolution(fdc.resolution)
    dtype = _perception_dtype(fdc)
    rows = torch.tensor(TRAINABLE)
    e_params, e_cfg = edit_gen if edit_gen is not None else (gen_params,
                                                             gen_cfg)

    if edit_fn is None:
        def edit_fn(delta_s, styles):
            return styles + assemble_direction(delta_s)

    def loss_fn(trainable, styles, id_feats_orig, clip_feats_orig,
                landmarks_refs=None, text_dirs=None):
        styles2 = edit_fn(trainable, styles)
        lead = styles2.shape[:-2]
        img = synthesis(e_params, e_cfg,
                        styles2.reshape(-1, *styles2.shape[-2:]),
                        until_k=until_k, noise_mode=fdc.noise_mode)

        id_f = _id_features(arcface_params, img, fdc).reshape(*lead, -1)
        identity_loss = torch.mean(1.0 - torch.sum(id_f * id_feats_orig,
                                                   dim=-1), dim=-1)
        identity_loss = identity_loss * fdc.identity_loss_coef

        clip_loss = 0.0
        for i, (b, orig_f) in enumerate(zip(bundles, clip_feats_orig)):
            f_tgt = _clip_image_features(b, img, fdc.clip_loss_type,
                                         dtype).reshape(*lead, -1)
            clip_loss = clip_loss + b.weight * _clip_term(
                b, fdc.clip_loss_type, f_tgt, orig_f,
                text_dirs[i] if text_dirs else None)
        clip_loss = clip_loss * fdc.clip_loss_coef

        r = rows.to(styles.device)
        l2 = fdc.l2_reg_coef * torch.mean(torch.square(
            styles2.index_select(-2, r) - styles.index_select(-2, r)),
            dim=(-3, -2, -1))

        loss = identity_loss + clip_loss + l2
        aux = {"clip_loss": clip_loss, "identity_loss": identity_loss,
               "l2_loss": l2}
        if fdc.landmarks_in_graph:
            boxes, lm_orig = landmarks_refs
            lm_edit = crop_landmarks(mobilenet_params, img, boxes)
            side = (boxes[:, 2] - boxes[:, 0]).reshape(-1, 1, 1)
            lm_term = fdc.landmarks_loss_coef * landmarks_loss(
                lm_edit * side, lm_orig * side)
            loss = loss + lm_term
            aux["landmarks_loss"] = lm_term
        return loss, aux

    return loss_fn


def detect_crop_boxes(frames_u8: np.ndarray, mtcnn, resolution: int
                      ) -> np.ndarray:
    """The crop box of each frame's best MTCNN face (`square_crop_box`),
    or the full frame where none is found: [N, 4] float32."""
    from ..models.mtcnn.detect import detect_faces
    from ..ops.image import square_crop_box

    boxes = []
    for frame in frames_u8:
        try:
            faces, _ = detect_faces(frame, mtcnn)
        except Exception:  # noqa: BLE001 the reference reuses the originals
            faces = []
        if len(faces):
            boxes.append(square_crop_box(faces[np.argmax(faces[:, 4])]))
        else:
            boxes.append(np.asarray([0, 0, resolution, resolution],
                                    np.float32))
    return np.stack(boxes)


def prepare_landmarks_refs(gen_params, gen_cfg: GeneratorConfig,
                           styles_array: torch.Tensor,
                           fdc: FindDirectionConfig, landmarker,
                           chunk: int = 8):
    """Once per run, for the in-graph landmarks loss: render every
    original, detect its best face with MTCNN on the host (undetected: the
    full frame), and record its landmarks through the step's own crop and
    landmarker. → (boxes [N, 4], landmarks [N, 68, 2]) on the device of
    the styles."""
    from ..edit import to_uint8_hwc

    until_k = until_k_for_resolution(fdc.resolution)
    boxes_all, lm_all = [], []
    with torch.no_grad():
        for i in range(0, styles_array.shape[0], chunk):
            img = synthesis(gen_params, gen_cfg, styles_array[i:i + chunk],
                            until_k=until_k, noise_mode=fdc.noise_mode)
            boxes = torch.from_numpy(detect_crop_boxes(
                to_uint8_hwc(img), landmarker.mtcnn, fdc.resolution)
                ).to(img.device)
            lm_all.append(crop_landmarks(landmarker.params, img, boxes))
            boxes_all.append(boxes)
    return torch.cat(boxes_all), torch.cat(lm_all)


def make_landmarks_metric_fn(gen_params, gen_cfg: GeneratorConfig,
                             fdc: FindDirectionConfig, landmarker):
    """The logging-only landmarks metric (the reference's
    compute_landmarks_loss): render the original and edited batches,
    detect 68 landmarks on each (MTCNN → MobileNet), MSE over the
    non-jawline points; 0 when an original has no face, the originals'
    landmarks where an edit has none. metric(direction [1, 26, 512],
    styles [B, 26, 512]) → float."""
    from ..edit import to_uint8_hwc

    until_k = until_k_for_resolution(fdc.resolution)

    def render(styles):
        with torch.no_grad():
            return to_uint8_hwc(synthesis(gen_params, gen_cfg, styles,
                                          until_k=until_k,
                                          noise_mode=fdc.noise_mode))

    def metric(direction, styles):
        lm1 = landmarker.detect_batch(list(render(styles)))
        if lm1 is None:
            return 0.0
        lm2 = landmarker.detect_batch(list(render(styles + direction)))
        if lm2 is None:
            lm2 = lm1
        return float(landmarks_loss(
            torch.from_numpy(lm1.astype(np.float32)),
            torch.from_numpy(lm2.astype(np.float32))))

    return metric


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


def _styles_on(styles_array, dev: torch.device) -> torch.Tensor:
    if not isinstance(styles_array, torch.Tensor):
        styles_array = torch.tensor(np.asarray(styles_array, np.float32))
    return styles_array.to(dev, torch.float32)


def _initial_delta(fdc: FindDirectionConfig, dev: torch.device,
                   resume_direction=None) -> torch.Tensor:
    """Δs [1, 8, 512]: the trainable rows of `resume_direction`, else
    N(0, 1)·1e-3 from a CPU `torch.Generator` seeded with fdc.seed (the
    JAX package draws it from `jax.random`, which torch cannot
    reproduce)."""
    if resume_direction is not None:
        return torch.as_tensor(np.asarray(resume_direction, np.float32)
                               [:, TRAINABLE]).to(dev)
    gen = torch.Generator().manual_seed(fdc.seed)
    return (torch.randn((1, len(TRAINABLE), STYLE_DIM), generator=gen)
            * 1e-3).to(dev)


def _sgd_step(loss_fn, bank, delta_s, idx, lr, text_dirs=None):
    """One SGD step (optax.sgd: params + (−lr)·g, lr rounded to float32) on
    the batch rows `idx` of bank = (styles, id feats, clip feats, landmarks
    refs or None). → (Δs, loss, aux, grad norm), one loss and norm per
    prompt where Δs has a prompt axis."""
    styles, id_all, clip_all, refs = bank
    refs = None if refs is None else tuple(t[idx] for t in refs)
    delta_s = delta_s.detach().requires_grad_(True)
    loss, aux = loss_fn(delta_s, styles[idx], id_all[idx],
                        tuple(c[idx] for c in clip_all), refs, text_dirs)
    grads, = torch.autograd.grad(loss.sum(), delta_s)
    with torch.no_grad():
        delta_s = delta_s.detach() + float(np.float32(-lr)) * grads
        grad_norm = torch.linalg.vector_norm(
            grads.reshape(*loss.shape, -1), dim=-1)
    return (delta_s, loss.detach(),
            {k: torch.as_tensor(v).detach() for k, v in aux.items()},
            grad_norm)


def _dp_step(loss_fns, bank, mesh: DataMesh, delta_s, idx, lr,
             text_dirs=None):
    """`_sgd_step` with the batch rows `idx` split over the mesh (and the
    process group): loss_fns maps each mesh device to the loss on its
    replicas. Each shard's loss, aux and Δs gradient (of its rows' mean)
    are combined into the full batch's on Δs's device; the grad norm is
    that of the combined gradient."""
    styles, id_all, clip_all, refs = bank
    keys: List[str] = []

    def shard(dev, rows):
        i = idx[rows]
        dl = delta_s.detach().to(dev).requires_grad_(True)
        loss, aux = loss_fns[dev](
            dl, styles[i].to(dev), id_all[i].to(dev),
            tuple(c[i].to(dev) for c in clip_all),
            None if refs is None else tuple(t[i].to(dev) for t in refs),
            tree_to(text_dirs, dev))
        g, = torch.autograd.grad(loss.sum(), dl)
        keys[:] = list(aux)
        return [loss.detach(), g] + [torch.as_tensor(aux[k]).detach()
                                     for k in keys]

    loss, grads, *aux = data_parallel(mesh, idx.shape[0], shard,
                                      delta_s.device)
    with torch.no_grad():
        new = delta_s.detach() + float(np.float32(-lr)) * grads
        grad_norm = torch.linalg.vector_norm(
            grads.reshape(*loss.shape, -1), dim=-1)
    return new, loss, dict(zip(keys, aux)), grad_norm


def _sgd_loop(delta_s, step, n_items: int, fdc: FindDirectionConfig,
              after_step: Optional[Callable] = None,
              device: Optional[torch.device] = None):
    """fdc.n_epochs epochs of ceil(n_items / batch) steps, each on a batch
    of one `RandomState(fdc.seed)` draw at the scheduled learning rate.
    after_step(it, total, lr, idx, Δs, loss, aux, grad_norm) runs after
    each step. delta_s is the trained state, a tensor or (the mapper
    trainer's) a module on `device`. → (Δs, loss history [steps, ...]
    numpy, info)."""
    dev = device if device is not None else delta_s.device
    num_batches = math.ceil(n_items / fdc.batch_size)
    total = num_batches * fdc.n_epochs
    rng = np.random.RandomState(fdc.seed)
    t0 = time.time()
    first_step_done = None
    history = []
    it = 0
    for _ in range(fdc.n_epochs):
        for _ in range(num_batches):
            it += 1
            lr = schedule_lr(fdc, it, total)
            idx = torch.as_tensor(
                rng.randint(0, n_items, size=fdc.batch_size)).to(dev)
            delta_s, loss, aux, grad_norm = step(delta_s, idx, lr)
            if it == 1:
                # one drain separates the first step (kernel builds, cuDNN
                # and cuBLAS set-up) from the steady steps
                loss.cpu()
                first_step_done = time.time()
            if after_step is not None:
                after_step(it, total, lr, idx, delta_s, loss, aux, grad_norm)
            history.append(loss)  # kept on the device: no sync per step
    hist = torch.stack(history).cpu().numpy() if history else \
        np.zeros((0,), np.float32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t0
    info = {"time": elapsed, "iterations": it}
    if first_step_done is not None and it > 1:
        info["first_step_time"] = first_step_done - t0
        info["steady_ms_per_step"] = (
            1e3 * (elapsed - (first_step_done - t0)) / (it - 1))
    return delta_s, hist, info


def find_direction(gen_params, gen_cfg: GeneratorConfig, styles_array,
                   clip_models: Dict[str, Tuple], arcface_params,
                   fdc: FindDirectionConfig,
                   tokenizer=None,
                   mesh: Optional[DataMesh] = None,
                   resume_direction: Optional[np.ndarray] = None,
                   callback: Optional[Callable] = None,
                   landmarks_metric_fn: Optional[Callable] = None,
                   landmarker=None):
    """Run the optimization on the device that holds `gen_params`. Returns
    (direction [1, 26, 512] tensor on that device, info).

    mesh: a 1-axis `parallel.DataMesh`; each step's batch splits over its
    devices (fdc.batch_size must divide over them and the process group),
    the models replicated once per distinct device (`_dp_step`).

    styles_array: [n_items, 26, 512]; clip_models: {'ViT-B/32': (cfg,
    params)}. callback(iteration, loss, aux, lr, grad_norm, direction
    [1, 26, 512] numpy) every 10 iterations and at the last; its aux
    'landmarks_loss' is landmarks_loss_coef · landmarks_metric_fn(direction,
    batch styles) where that is given, the in-graph term with
    fdc.landmarks_in_graph, else 0. fdc.landmarks_in_graph needs
    `landmarker` (cv.landmarks.Landmarker). Without `resume_direction`, Δs
    starts at `_initial_delta`'s draw.
    """
    dev = gen_params["mapping"]["w_avg"].device
    if fdc.landmarks_in_graph:
        if fdc.split_step:
            raise ValueError(
                "landmarks_in_graph is not supported with split_step")
        if landmarker is None:
            raise ValueError("landmarks_in_graph needs a landmarker "
                             "(MTCNN and MobileNet weights)")
    mobilenet_params = landmarker.params if fdc.landmarks_in_graph else None
    for tree in (gen_params, arcface_params, mobilenet_params,
                 [p for _, p in clip_models.values()]):
        _freeze(tree)
    styles_array = _styles_on(styles_array, dev)
    n_items = styles_array.shape[0]
    bundles = make_clip_bundles(fdc, clip_models, tokenizer)

    id_feats_orig_all, clip_feats_orig_all = precompute_original_features(
        gen_params, gen_cfg, styles_array, bundles, arcface_params, fdc)
    refs = None
    if fdc.landmarks_in_graph:
        refs = prepare_landmarks_refs(gen_params, gen_cfg, styles_array, fdc,
                                      landmarker)

    loss_fn = make_loss_fn(gen_params, gen_cfg, bundles, arcface_params, fdc,
                           mobilenet_params=mobilenet_params)
    bank = (styles_array, id_feats_orig_all, clip_feats_orig_all, refs)
    mesh = as_mesh(mesh)
    if mesh is None:
        step = functools.partial(_sgd_step, loss_fn, bank)
    else:
        models = (gen_params, bundles, arcface_params, mobilenet_params)

        def build(d):
            gp, bs, arc, mob = tree_to(models, d)
            return make_loss_fn(gp, gen_cfg, bs, arc, fdc,
                                mobilenet_params=mob)

        step = functools.partial(
            _dp_step, {d: loss_fn if d == dev else build(d)
                       for d in mesh.distinct}, bank, mesh)

    def after_step(it, total, lr, idx, delta_s, loss, aux, grad_norm):
        if callback is None or (it % 10 != 0 and it != total):
            return
        direction = assemble_direction(delta_s)
        aux_out = {k: float(v) for k, v in aux.items()}
        if landmarks_metric_fn is not None and fdc.landmarks_loss_coef != 0:
            aux_out["landmarks_loss"] = fdc.landmarks_loss_coef * float(
                landmarks_metric_fn(direction, styles_array[idx]))
        else:
            aux_out.setdefault("landmarks_loss", 0.0)
        callback(it, float(loss), aux_out, lr, float(grad_norm),
                 direction.cpu().numpy())

    delta_s, hist, info = _sgd_loop(_initial_delta(fdc, dev,
                                                   resume_direction),
                                    step, n_items, fdc, after_step)
    info["history"] = [float(x) for x in hist]
    return assemble_direction(delta_s), info


class DirectionEngine:
    """Prompt sweeps over one precompute: the original-image features are
    computed once, and each prompt's CLIP anchors are passed to the step
    (`optimize`), or P prompts train together (`optimize_batch`). Every
    prompt runs the batch stream of `find_direction` (RandomState(fdc.seed))
    and, fresh, its initial Δs.

        eng = DirectionEngine(params, cfg, styles, clip_models, arcface, fdc)
        d1, info1 = eng.optimize("a face with a big smile")
        d, info = eng.optimize_batch(["an old face", "a young face"])
    """

    def __init__(self, gen_params, gen_cfg: GeneratorConfig, styles_array,
                 clip_models: Dict[str, Tuple], arcface_params,
                 fdc: FindDirectionConfig, tokenizer=None):
        if fdc.landmarks_in_graph:
            raise ValueError("DirectionEngine does not support "
                             "landmarks_in_graph; use find_direction()")
        if fdc.split_step or fdc.steps_per_dispatch > 1:
            warnings.warn(
                "DirectionEngine runs one step per dispatch; split_step and "
                "steps_per_dispatch are ignored on the prompt-sweep path",
                stacklevel=2)
        self.fdc = fdc
        self.tokenizer = tokenizer
        self.device = gen_params["mapping"]["w_avg"].device
        for tree in (gen_params, arcface_params,
                     [p for _, p in clip_models.values()]):
            _freeze(tree)
        self.styles_array = _styles_on(styles_array, self.device)
        self.n_items = self.styles_array.shape[0]
        # prompt-less bundles: the anchors come with each prompt
        self.bundles = [CLIPBundle(cfg=clip_models[name][0],
                                   params=clip_models[name][1], weight=w)
                        for name, w in _clip_names_weights(fdc)]
        self.id_feats, self.clip_feats = precompute_original_features(
            gen_params, gen_cfg, self.styles_array, self.bundles,
            arcface_params, fdc)
        self._gen = (gen_params, gen_cfg, arcface_params)
        self._bank = (self.styles_array, self.id_feats, self.clip_feats, None)
        self._loss_fns = {self.device: make_loss_fn(
            gen_params, gen_cfg, self.bundles, arcface_params, fdc)}
        self._banks = {self.device: self._bank}
        self._step = functools.partial(
            _sgd_step, self._loss_fns[self.device], self._bank)

    def _loss_fn_on(self, dev: torch.device):
        """The loss on `dev`'s replicas of the models, and the bank on
        `dev`, each made once."""
        if dev not in self._loss_fns:
            gp, cfg, arc = self._gen
            gp, bundles, arc = tree_to((gp, self.bundles, arc), dev)
            self._loss_fns[dev] = make_loss_fn(gp, cfg, bundles, arc,
                                               self.fdc)
            self._banks[dev] = tree_to(self._bank, dev)
        return self._loss_fns[dev]

    def _mesh_step(self, mesh: DataMesh, text_dirs, deltas, idx, lr):
        """One step of P prompts sharded over the mesh: prompt group g
        (P / groups prompts) on its device, unsharded on a 1-axis mesh,
        its batch over the group's 'data' devices on a 2-axis one; the
        groups share no collective. → `_sgd_step`'s outputs, concatenated
        over the prompts on Δs's device."""
        groups = mesh.prompt_groups()
        per = deltas.shape[0] // len(groups)
        outs = []
        for g, sub in enumerate(groups):
            d = mesh.group_device(g)
            rows = slice(g * per, (g + 1) * per)
            td = tuple({k: v[rows] for k, v in t.items()} for t in text_dirs)
            if sub is None:
                out = _sgd_step(self._loss_fn_on(d), self._banks[d],
                                deltas[rows].to(d), idx.to(d), lr,
                                tree_to(td, d))
            else:
                fns = {x: self._loss_fn_on(x) for x in sub.distinct}
                out = _dp_step(fns, self._bank, sub, deltas[rows].to(d), idx,
                               lr, td)
            outs.append(out)
        dev = deltas.device
        return (torch.cat([o[0].to(dev) for o in outs]),
                torch.cat([o[1].to(dev) for o in outs]),
                {k: torch.cat([o[2][k].to(dev) for o in outs])
                 for k in outs[0][2]},
                torch.cat([o[3].to(dev) for o in outs]))

    def _text_dirs(self, text_prompt: str, negative_text_prompt: str):
        """One anchor dict per bundle for the prompt pair."""
        dirs = []
        with torch.no_grad():
            for b in self.bundles:
                if self.fdc.clip_loss_type in ("nada", "nada_global"):
                    b = dataclasses.replace(b, nada_anchors=NADATextAnchors.create(
                        b.params, b.cfg, negative_text_prompt, text_prompt,
                        tokenizer=self.tokenizer))
                else:
                    b = dataclasses.replace(b, text_direction=make_text_direction(
                        b.params, b.cfg,
                        tokenize([text_prompt], tokenizer=self.tokenizer),
                        tokenize([negative_text_prompt],
                                 tokenizer=self.tokenizer)))
                dirs.append(_anchors(b))
        return tuple(dirs)

    def optimize(self, text_prompt: str,
                 negative_text_prompt: Optional[str] = None,
                 resume_direction: Optional[np.ndarray] = None,
                 callback: Optional[Callable] = None):
        """→ (direction [1, 26, 512], info), `find_direction`'s contract.
        callback(iteration, loss, aux, lr, direction numpy) every 10
        iterations."""
        fdc = self.fdc
        neg = negative_text_prompt if negative_text_prompt is not None \
            else fdc.negative_text_prompt
        text_dirs = self._text_dirs(text_prompt, neg)

        def after_step(it, total, lr, idx, delta_s, loss, aux, grad_norm):
            if callback is not None and it % 10 == 0:
                callback(it, float(loss),
                         {k: float(v) for k, v in aux.items()}, lr,
                         assemble_direction(delta_s).cpu().numpy())

        delta_s, hist, info = _sgd_loop(
            _initial_delta(fdc, self.device, resume_direction),
            functools.partial(self._step, text_dirs=text_dirs),
            self.n_items, fdc, after_step)
        info["history"] = [float(x) for x in hist]
        return assemble_direction(delta_s), info

    def optimize_batch(self, text_prompts: List[str],
                       negative_text_prompts: Optional[List[str]] = None,
                       mesh=None,
                       resume_directions: Optional[Sequence] = None,
                       callback: Optional[Callable] = None):
        """Train P directions at once, the prompt axis folded into the
        image batch (one synthesis, CLIP and ArcFace call of P·batch_size
        images a step). Each prompt matches its serial `optimize()` run
        up to the summation order of the larger batch. resume_directions:
        one direction (or None, a fresh start) per prompt.
        callback(iteration, losses, aux arrays, lr, directions [P, 1, 26,
        512] numpy) every 10 iterations.

        mesh: a `parallel.DataMesh`. On a 1-axis mesh the prompts shard
        over its devices (the prompt count must divide over them); on a
        2-axis ('prompt', 'data') mesh (`zoo_mesh`) over 'prompt', and
        each group's image batch over 'data' (fdc.batch_size must divide
        over it). The prompts share no collective.

        → (directions [P, 1, 26, 512], info); info["history"] is [P,
        steps]."""
        mesh = as_mesh(mesh)
        fdc = self.fdc
        P = len(text_prompts)
        if mesh is not None:
            p_axis = "prompt" if "prompt" in mesh.axis_names \
                else mesh.axis_names[0]
            n_p = mesh.shape[p_axis]
            assert P % n_p == 0, f"{P} prompts over {n_p} '{p_axis}' shards"
            if "prompt" in mesh.axis_names:
                assert fdc.batch_size % mesh.shape["data"] == 0, (
                    f"batch {fdc.batch_size} over {mesh.shape['data']} "
                    "'data' shards")
        if negative_text_prompts is None:
            negative_text_prompts = [fdc.negative_text_prompt] * P
        if len(negative_text_prompts) != P:
            raise ValueError(f"{len(negative_text_prompts)} negative prompts "
                             f"for {P} prompts")
        per_prompt = [self._text_dirs(t, n)
                      for t, n in zip(text_prompts, negative_text_prompts)]
        text_dirs = tuple(
            {k: torch.stack([p[i][k] for p in per_prompt]) for k in anchors}
            for i, anchors in enumerate(per_prompt[0]))

        fresh = _initial_delta(fdc, self.device)
        if resume_directions is not None:
            if len(resume_directions) != P:
                raise ValueError(f"{len(resume_directions)} resume "
                                 f"directions for {P} prompts")
            deltas = torch.stack([
                fresh if d is None else _initial_delta(fdc, self.device, d)
                for d in resume_directions])
        else:
            deltas = fresh.expand(P, *fresh.shape).clone()

        def after_step(it, total, lr, idx, deltas, losses, aux, grad_norm):
            if callback is not None and it % 10 == 0:
                callback(it, [float(x) for x in losses.cpu()],
                         {k: v.cpu().numpy() for k, v in aux.items()}, lr,
                         assemble_direction(deltas).cpu().numpy())

        step = functools.partial(self._step, text_dirs=text_dirs) \
            if mesh is None else \
            functools.partial(self._mesh_step, mesh, text_dirs)
        deltas, hist, info = _sgd_loop(deltas, step, self.n_items, fdc,
                                       after_step)
        info["history"] = hist.T if len(hist) else np.zeros((P, 0),
                                                            np.float32)
        info["prompts"] = list(text_prompts)
        return assemble_direction(deltas), info
