"""e4e inversion-encoder trainer, the Coach (counterpart of
`stylemc_tpu/train/coach.py`).

Ranger over the encoder (and the decoder with train_decoder); the loss is
the latent discriminator's adversarial term (softplus), the progressive
delta-norm term, the ArcFace or MoCo identity term, L2, LPIPS and W-norm.
The latent-codes discriminator trains first in every step (softplus on
real and fake w, Adam), with a lazy R1 penalty every d_reg_every steps:
a double backward through the MLP and a second Adam step on the updated
discriminator. The encoder then steps against the updated discriminator.
The progressive stage advances on a step schedule.

The JAX package runs the discriminator phase and the encoder step either
as one jit dispatch (fuse_d_step) or as three; in eager torch both are the
same sequence of operations, and fuse_d_step only keeps the JAX fused
path's loss keys (a 0.0 R1 entry on other steps, dropped when fetched).
The decoder launches B1 in each synthesis call and B2 in each backward
through it; the batches and the z of the real w stay host-side numpy
streams drawn in the JAX package's order.

The coach trains copies of the encoder (and decoder) params on its
device; read them from `coach.psp`.

With a mesh (`parallel.DataMesh`) the image batch splits over its devices
in the encoder step, the discriminator step and its R1, and the latent
sampling: each shard's losses (every one a mean over the batch) and their
gradients on its device, combined by the shard's share of the rows and
summed over the process group when one is up; Ranger and Adam then step
once. The W pools see the whole batch: sampled latents are gathered
before the query.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import as_float32, params_from_numpy
from ..device import DeviceLike, disable_tf32, resolve_device
from ..io.numpy_pickle import load_numpy_pickle
from ..losses.lpips import lpips_loss
from ..losses.moco import e4e_id_loss, moco_loss
from ..losses.w_norm import w_norm_loss
from ..models.e4e.discriminator import (LatentCodesPool, discriminator_apply,
                                        init_discriminator_params)
from ..models.e4e.psp import ENCODERS, PSP
from ..models.e4e.encoders import style_count
from ..models.stylegan2.generator import mapping as gen_mapping
from ..parallel.mesh import (all_gather_rows, as_mesh, data_parallel,
                             shard_rows, tree_to)
from .ranger import (apply_updates, clip_by_global_norm, ranger, tree_leaves,
                     tree_map)


@dataclasses.dataclass
class CoachOptions:
    """The reference TrainOptions' defaults."""
    dataset_type: str = "ffhq_encode"
    encoder_type: str = "Encoder4Editing"
    batch_size: int = 4
    test_batch_size: int = 2
    learning_rate: float = 1e-4
    optim_name: str = "ranger"
    train_decoder: bool = False
    start_from_latent_avg: bool = True
    lpips_type: str = "alex"
    lpips_lambda: float = 0.8
    id_lambda: float = 0.1
    l2_lambda: float = 1.0
    w_norm_lambda: float = 0.0
    stylegan_size: int = 1024
    max_steps: int = 500000
    board_interval: int = 50
    val_interval: int = 1000
    save_interval: Optional[int] = None
    w_discriminator_lambda: float = 0.0
    w_discriminator_lr: float = 2e-5
    r1: float = 10.0
    d_reg_every: int = 16
    use_w_pool: bool = False
    w_pool_size: int = 50
    delta_norm: int = 2
    delta_norm_lambda: float = 2e-4
    progressive_steps: Optional[List[int]] = None
    progressive_start: Optional[int] = None
    progressive_step_every: int = 2000
    exp_dir: str = "experiments/e4e"
    seed: int = 0
    # global-norm gradient clip before the optimizer (0 = off)
    grad_clip: float = 0.0
    # bf16 activations in the decoder's upper num_fp16_res blocks; params
    # and optimizer state stay fp32
    bf16: bool = False
    # bf16 on every decoder block; implies bf16
    bf16_full: bool = False
    # bf16 activations through LPIPS and the identity tower; the losses and
    # all trainable state stay fp32
    perception_bf16: bool = False
    # the encoder's forward in bf16 from fp32 master weights
    encoder_bf16: bool = False
    # the JAX package's single-dispatch discriminator step; here the same
    # operations either way (see the module docstring)
    fuse_d_step: bool = True
    # with a remat decoder config, checkpoint only blocks at resolution >=
    # this (0 = all)
    remat_min_res: int = 0
    # fetch losses to the host every N steps (board, save, validation and
    # the last step always fetch); callbacks fire on fetch steps
    fetch_every: int = 1
    # depth of the background-thread batch prefetcher in train() (0 = call
    # train_iter inline); one worker keeps the batch order
    prefetch_batches: int = 2

    def __post_init__(self):
        if self.progressive_start is not None:
            n = style_count(self.stylegan_size)
            self.progressive_steps = [0] + [
                self.progressive_start + i * self.progressive_step_every
                for i in range(n - 1)]
        if self.save_interval is None:
            self.save_interval = self.max_steps


class _Prefetcher:
    """One background thread pulling batches from `fn` ahead of the
    training loop (depth-bounded); the worker's exception re-raises at the
    next get()."""

    def __init__(self, fn: Callable, depth: int = 2):
        import queue
        import threading

        self._q: Any = queue.Queue(maxsize=max(1, depth))
        self._fn = fn
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import queue
        while not self._stop.is_set():
            try:
                item = self._fn()
            except BaseException as e:  # noqa: BLE001 — re-raised by get()
                self._err = e
                self._q.put(None)
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def get(self):
        item = self._q.get()
        if item is None and self._err is not None:
            raise self._err
        return item

    def close(self):
        import queue
        self._stop.set()
        try:  # unblock a worker waiting on put()
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class _RangerStep:
    """An optax-style transform and its state, stepping a params tree in
    place."""

    def __init__(self, tx, params, clip: float):
        self.tx = tx
        self.clip = clip_by_global_norm(clip) if clip > 0 else None
        self.state = tx.init(params)

    @torch.no_grad()
    def step(self, params, grads):
        if self.clip is not None:
            grads, _ = self.clip.update(grads, {})
        updates, self.state = self.tx.update(grads, self.state, params)
        apply_updates(params, updates)

    def state_tree(self):
        return self.state

    def load_state_tree(self, tree, device):
        self.state = _restore(self.state, tree, device)


class _AdamStep:
    """torch.optim.Adam (optax.adam's defaults) over a params tree's
    leaves, fed gradients explicitly."""

    def __init__(self, params, lr: float, clip: float = 0.0):
        self.leaves = tree_leaves(params)
        self.clip = clip_by_global_norm(clip) if clip > 0 else None
        self.opt = torch.optim.Adam(self.leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    @torch.no_grad()
    def step(self, params, grads):
        if self.clip is not None:
            grads, _ = self.clip.update(grads, {})
        for p, g in zip(self.leaves, tree_leaves(grads)):
            p.grad = g
        self.opt.step()
        for p in self.leaves:
            p.grad = None

    def state_tree(self):
        return {str(i): dict(s) for i, s in self.opt.state_dict()["state"]
                .items()}

    def load_state_tree(self, tree, device):
        sd = self.opt.state_dict()
        # load_state_dict puts the moments on each param's device
        sd["state"] = {int(i): {k: torch.as_tensor(np.asarray(v))
                                for k, v in s.items()}
                       for i, s in tree.items()}
        self.opt.load_state_dict(sd)


def _owned(tree, device):
    """A copy of a params tree on `device` in float32, every leaf its own
    storage."""
    return tree_map(lambda t: t.detach().to(device, torch.float32, copy=True),
                    params_from_numpy(tree, device))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _restore(template, saved, device):
    """A saved state tree (numpy leaves) laid onto the layout of
    `template`: tensors become tensors on `device` in the template leaf's
    dtype, ints ints."""
    if isinstance(template, dict):
        # a stateless transform's {} leaves no array in a directory
        return {k: _restore(v, saved.get(k, {}), device)
                for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(saved)).to(device, template.dtype)
    if isinstance(template, int):
        return int(saved)
    return saved


def _flatten(tree, prefix=""):
    """{path/to/leaf: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat):
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _copy_into(params, arrays):
    """Write saved arrays into a params tree's tensors in place, so the
    optimizers keep their references."""
    with torch.no_grad():
        for key, t in params.items():
            if isinstance(t, dict):
                _copy_into(t, arrays[key])
            else:
                t.copy_(torch.as_tensor(np.asarray(arrays[key])))


class Coach:
    """The host-side training loop.

    psp: the PSP bundle (encoder trained; decoder frozen unless
      train_decoder). perception: {'lpips': params, 'arcface' | 'moco':
      params}. train_iter / test_iter: callables → (x, y) numpy batches in
      [-1, 1], NCHW. device: cuda unless the caller asks for the CPU; the
      coach copies psp's params and puts perception's there. mesh: a 1-axis
      `parallel.DataMesh` over which the batch splits (batch_size must
      divide over it); the state stays on `device`.
    """

    def __init__(self, opts: CoachOptions, psp: PSP,
                 perception: Dict[str, Any],
                 train_iter: Callable, test_iter: Optional[Callable] = None,
                 arcface_layout=None, mesh=None, device: DeviceLike = None):
        self.mesh = as_mesh(mesh)
        if self.mesh is not None:
            n_dev = self.mesh.size
            assert opts.batch_size % n_dev == 0, \
                f"batch_size {opts.batch_size} must divide over {n_dev} devices"
        self._replicas: Dict[torch.device, Any] = {}
        dev = resolve_device(device)
        disable_tf32(dev)
        self.device = dev
        self.opts = opts
        dec_cfg = psp.decoder_cfg
        if opts.remat_min_res > 0 and dec_cfg.remat:
            dec_cfg = dataclasses.replace(dec_cfg,
                                          remat_min_res=opts.remat_min_res)
        if opts.bf16 or opts.bf16_full:
            dec_cfg = dataclasses.replace(dec_cfg,
                                          low_precision_dtype="bfloat16")
            if opts.bf16_full:
                dec_cfg = dataclasses.replace(
                    dec_cfg, num_fp16_res=len(dec_cfg.block_resolutions))
        self.psp = dataclasses.replace(
            psp, decoder_cfg=dec_cfg,
            encoder_params=_owned(psp.encoder_params, dev),
            decoder_params=_owned(psp.decoder_params, dev),
            latent_avg=None if psp.latent_avg is None
            else as_float32(psp.latent_avg, dev))
        self.perception = params_from_numpy(perception, dev)
        self.train_iter = train_iter
        self.test_iter = test_iter
        self.arcface_layout = arcface_layout
        self.global_step = 0
        self.best_val_loss = None
        for p in tree_leaves(self._trainable()):
            p.requires_grad_(True)

        self.optimizer = self._make_optimizer()

        self.discriminator_params = None
        if opts.w_discriminator_lambda > 0:
            self.discriminator_params = init_discriminator_params(
                torch.Generator().manual_seed(opts.seed + 1), device=dev)
            for p in tree_leaves(self.discriminator_params):
                p.requires_grad_(True)
            self.d_optimizer = _AdamStep(self.discriminator_params,
                                         opts.w_discriminator_lr)
            self.real_w_pool = LatentCodesPool(opts.w_pool_size)
            self.fake_w_pool = LatentCodesPool(opts.w_pool_size)
        self._rng = np.random.RandomState(opts.seed)

    # ------------------------------------------------------------- plumbing

    def _trainable(self):
        if self.opts.train_decoder:
            return {"encoder": self.psp.encoder_params,
                    "decoder": self.psp.decoder_params}
        return {"encoder": self.psp.encoder_params}

    def _make_optimizer(self):
        if self.opts.optim_name == "ranger":
            return _RangerStep(ranger(self.opts.learning_rate),
                               self._trainable(), self.opts.grad_clip)
        return _AdamStep(self._trainable(), self.opts.learning_rate,
                         self.opts.grad_clip)

    def _to_device(self, a) -> torch.Tensor:
        """A host batch as float32 on the device, copied from pinned memory
        without waiting for the device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def progressive_stage(self) -> int:
        """The stage index at the current global step."""
        if not self.opts.progressive_steps:
            return 18
        stage = 0
        for i, s in enumerate(self.opts.progressive_steps):
            if self.global_step >= s:
                stage = i
        return stage

    def get_dims_to_discriminate(self) -> List[int]:
        n = style_count(self.opts.stylegan_size)
        if self.opts.progressive_steps:
            return list(range(min(self.progressive_stage() + 1, n)))
        return list(range(n))

    def is_training_discriminator(self) -> bool:
        return self.opts.w_discriminator_lambda > 0

    # ----------------------------------------------------------- loss graph

    def _frozen_on(self, dev):
        """(psp, perception) on `dev`: the coach's own on its device, else
        copies made once (the trained params come with each call)."""
        if dev == self.device:
            return self.psp, self.perception
        if dev not in self._replicas:
            psp = dataclasses.replace(
                self.psp, encoder_params={},
                decoder_params={} if self.opts.train_decoder
                else self.psp.decoder_params)
            self._replicas[dev] = tree_to((psp, self.perception), dev)
        return self._replicas[dev]

    def _value_and_grad(self, fn, tree, n: int):
        """fn(tree, rows, device) → (loss, {name: scalar}) on the batch
        rows `rows` (each value a mean over them) on `device`. → ({name:
        value}, the loss's gradient as a tree like `tree`) of the whole
        batch of n: on the mesh, each shard on its own leaves, combined by
        its share of the rows. Unused leaves get zeros."""
        def grads_of(loss, t):
            return torch.autograd.grad(loss, tree_leaves(t), allow_unused=True,
                                       materialize_grads=True)

        if self.mesh is None:
            loss, vals = fn(tree, slice(None), self.device)
            grads = iter(grads_of(loss, tree))
            return ({k: torch.as_tensor(v).detach() for k, v in vals.items()},
                    tree_map(lambda _: next(grads), tree))
        keys: List[str] = []

        def shard(dev, rows):
            t = tree_map(lambda p: p.detach().to(dev).requires_grad_(True),
                         tree)
            loss, vals = fn(t, rows, dev)
            keys[:] = list(vals)
            return [*grads_of(loss, t)] + [torch.as_tensor(vals[k]).detach()
                                           for k in keys]

        n_leaves = len(tree_leaves(tree))
        out = data_parallel(self.mesh, n, shard, self.device)
        grads = iter(out[:n_leaves])
        return (dict(zip(keys, out[n_leaves:])),
                tree_map(lambda _: next(grads), tree))

    def _map_rows(self, fn, *xs):
        """fn(device, *row blocks) → a tuple of per-row tensors; on the
        mesh, each shard on its device and the rows gathered in batch
        order on the coach's device (across the process group too)."""
        if self.mesh is None:
            return fn(self.device, *xs)
        parts = [fn(d, *(x[rows].to(d) for x in xs))
                 for d, rows in shard_rows(self.mesh, xs[0].shape[0])]
        return tuple(all_gather_rows(torch.cat([p[i].to(self.device)
                                                for p in parts]))
                     for i in range(len(parts[0])))

    def _calc_loss(self, trainable, x, y, stage, disc_params, frozen=None):
        """→ (loss, (loss dict, y_hat, latent)): the encoder's loss on one
        batch, differentiable to `trainable`. frozen: (psp, perception) on
        x's device (`_frozen_on`); by default the coach's own."""
        base, perception = frozen if frozen is not None else (
            self.psp, self.perception)
        opts = self.opts
        enc_params = trainable["encoder"]
        x_enc = x
        if opts.encoder_bf16:
            enc_params = tree_map(lambda a: a.to(torch.bfloat16)
                                  if a.dtype == torch.float32 else a,
                                  enc_params)
            x_enc = x.to(torch.bfloat16)
        psp = dataclasses.replace(
            base, encoder_params=enc_params,
            decoder_params=trainable.get("decoder", base.decoder_params))
        codes = psp.encode(x_enc, progressive_stage=stage).float()
        y_hat = psp.decode(codes, resize=True, noise_mode="const")
        if opts.dataset_type == "cars_encode":
            # cars render 512x384 content in a 512x512 frame
            y_hat = y_hat[:, :, 32:224, :]
        latent = codes

        loss = 0.0
        loss_dict = {}
        if self.is_training_discriminator():
            dims = self.get_dims_to_discriminate()
            loss_disc = 0.0
            for i in dims:
                fake_pred = discriminator_apply(disc_params, latent[:, i, :])
                loss_disc = loss_disc + torch.mean(F.softplus(-fake_pred))
            loss_disc = loss_disc / len(dims)
            loss_dict["encoder_discriminator_loss"] = loss_disc
            loss = loss + opts.w_discriminator_lambda * loss_disc

        if opts.progressive_steps and stage != 18:
            first_w = latent[:, 0, :]
            total_delta = latent.new_zeros(())
            n = style_count(opts.stylegan_size)
            for i in range(1, min(stage + 1, n)):
                delta = latent[:, i, :] - first_w
                total_delta = total_delta + torch.mean(torch.linalg.vector_norm(
                    delta, ord=opts.delta_norm, dim=1))
            loss_dict["total_delta_loss"] = total_delta
            loss = loss + opts.delta_norm_lambda * total_delta

        if opts.perception_bf16:
            yp_hat, yp, xq = (t.to(torch.bfloat16) for t in (y_hat, y, x))
        else:
            yp_hat, yp, xq = y_hat, y, x
        if opts.id_lambda > 0:
            if "arcface" in perception:
                loss_id, sim = e4e_id_loss(perception["arcface"], yp_hat, yp,
                                           xq, self.arcface_layout)
            else:
                loss_id, sim = moco_loss(perception["moco"], yp_hat, yp, xq)
            loss_id = loss_id.float()
            loss_dict["loss_id"] = loss_id
            loss_dict["id_improve"] = sim.float()
            loss = loss + loss_id * opts.id_lambda
        if opts.l2_lambda > 0:
            loss_l2 = torch.mean((y_hat - y).square())
            loss_dict["loss_l2"] = loss_l2
            loss = loss + loss_l2 * opts.l2_lambda
        if opts.lpips_lambda > 0:
            loss_lp = lpips_loss(perception["lpips"], yp_hat, yp,
                                 opts.lpips_type).float()
            loss_dict["loss_lpips"] = loss_lp
            loss = loss + loss_lp * opts.lpips_lambda
        if opts.w_norm_lambda > 0:
            loss_w = w_norm_loss(latent, psp.latent_avg,
                                 opts.start_from_latent_avg)
            loss_dict["loss_w_norm"] = loss_w
            loss = loss + loss_w * opts.w_norm_lambda
        loss_dict["loss"] = loss
        return loss, (loss_dict, y_hat, latent)

    def encoder_gradients(self, x, y, stage: int):
        """The encoder step's loss dict (detached) and the gradient of its
        loss with respect to each trainable leaf, as a tree like
        `_trainable()`."""
        disc = self.discriminator_params

        def fn(trainable, rows, dev):
            loss, (loss_dict, _, _) = self._calc_loss(
                trainable, x[rows].to(dev), y[rows].to(dev), stage,
                tree_to(disc, dev), self._frozen_on(dev))
            return loss, loss_dict

        # the heads of rows past the progressive stage get zeros
        return self._value_and_grad(fn, self._trainable(), x.shape[0])

    # -------------------------------------------------------- discriminator

    def _d_loss(self, disc_params, real_w, fake_w):
        real_pred = discriminator_apply(disc_params, real_w)
        fake_pred = discriminator_apply(disc_params, fake_w)
        real_loss = torch.mean(F.softplus(-real_pred))
        fake_loss = torch.mean(F.softplus(fake_pred))
        return real_loss + fake_loss, (real_loss, fake_loss)

    def _r1_loss(self, disc_params, real_w):
        """r1/2 · mean ‖∇_w Σ D(w)‖² · d_reg_every, differentiable to the
        discriminator (a double backward)."""
        w = real_w.detach().requires_grad_(True)
        g, = torch.autograd.grad(discriminator_apply(disc_params, w).sum(), w,
                                 create_graph=True)
        pen = torch.mean(torch.sum(g.square().reshape(w.shape[0], -1), dim=1))
        return self.opts.r1 / 2 * pen * self.opts.d_reg_every

    def _d_step(self, real_w, fake_w, regularize: bool):
        dp = self.discriminator_params
        n = real_w.shape[0]

        def d_fn(p, rows, dev):
            loss, (rl, fl) = self._d_loss(p, real_w[rows].to(dev),
                                          fake_w[rows].to(dev))
            return loss, {"discriminator_loss": loss, "d_real_loss": rl,
                          "d_fake_loss": fl}

        out, grads = self._value_and_grad(d_fn, dp, n)
        self.d_optimizer.step(dp, grads)
        if regularize:
            # on the discriminator the step above updated; ∇_w D does not
            # depend on the biases: their gradients are 0
            def r1_fn(p, rows, dev):
                r1 = self._r1_loss(p, real_w[rows].to(dev))
                return r1, {"discriminator_r1_loss": r1}

            r1, grads = self._value_and_grad(r1_fn, dp, n)
            self.d_optimizer.step(dp, grads)
            out.update(r1)
        return out

    def _encoder_forward(self, enc_params, x, stage: int):
        """The raw encoder forward (no latent_avg) by encoder_type."""
        cfg = self.psp.cfg
        kw = {"layout": cfg.encoder_layout}
        if cfg.encoder_type == "Encoder4Editing":
            kw["progressive_stage"] = stage
        return ENCODERS[cfg.encoder_type](enc_params, x, cfg.stylegan_size,
                                          **kw)

    def sample_real_and_fake_latents(self, x):
        """Real w from the decoder's mapping of z ~ N(0, 1) (numpy, the
        coach's RandomState); fake w from the current encoder (its first
        row), both detached."""
        z = self._to_device(self._rng.randn(x.shape[0], 512))
        stage = self.progressive_stage()
        psp = self.psp

        def sample(dev, z, x):
            real_w = gen_mapping(tree_to(psp.decoder_params, dev),
                                 psp.decoder_cfg, z)[:, 0, :]
            fake_w = self._encoder_forward(tree_to(psp.encoder_params, dev),
                                           x, stage)
            if psp.cfg.start_from_latent_avg and psp.latent_avg is not None:
                fake_w = fake_w + psp.latent_avg[None].to(dev, fake_w.dtype)
            return real_w, fake_w

        with torch.no_grad():
            real_w, fake_w = self._map_rows(sample, z, x)
        if self.opts.progressive_steps:
            fake_w = fake_w[:, self.get_dims_to_discriminate(), :]
        if self.opts.use_w_pool:
            real_w = self._to_device(self.real_w_pool.query(real_w))
            fake_w = self._to_device(self.fake_w_pool.query(fake_w))
        if fake_w.ndim == 3:
            fake_w = fake_w[:, 0, :]
        return real_w.float(), fake_w.float()

    def train_discriminator(self, x):
        """One discriminator step (and R1 on its steps); the losses as
        device scalars."""
        real_w, fake_w = self.sample_real_and_fake_latents(x)
        return self._d_step(real_w, fake_w,
                            self.global_step % self.opts.d_reg_every == 0)

    # ------------------------------------------------------------ main loop

    def train_step(self, x, y, fetch: bool = True) -> Dict[str, Any]:
        """One optimisation step: the discriminator first, then the encoder
        against the updated discriminator. fetch=False returns the losses
        as device scalars and never waits for the device."""
        stage = self.progressive_stage()
        regularize = (self.is_training_discriminator()
                      and self.global_step % self.opts.d_reg_every == 0)
        x, y = self._to_device(x), self._to_device(y)
        d_dict = {}
        if self.is_training_discriminator():
            d_dict = self.train_discriminator(x)
            if (self.opts.fuse_d_step and not self.opts.use_w_pool
                    and not regularize):
                d_dict["discriminator_r1_loss"] = x.new_zeros(())
        enc_dict, grads = self.encoder_gradients(x, y, stage)
        self.optimizer.step(self._trainable(), grads)
        # keys in the order of the JAX package's jit outputs (sorted within
        # each dispatch), so that logs print alike
        merged = {**dict(sorted(d_dict.items())),
                  **dict(sorted(enc_dict.items()))}
        if self.is_training_discriminator() and self.opts.fuse_d_step \
                and not self.opts.use_w_pool:
            merged = dict(sorted(merged.items()))
        self.global_step += 1
        if not fetch:
            return merged
        # one device → host copy for every loss
        values = torch.stack([torch.as_tensor(v, device=self.device).float()
                              for v in merged.values()]).tolist()
        loss_dict = dict(zip(merged, values))
        if not regularize:
            loss_dict.pop("discriminator_r1_loss", None)
        return loss_dict

    def train(self, callback: Optional[Callable] = None,
              best_checkpoint_path: Optional[str] = None):
        """The main loop. When validation improves, best_val_loss is updated
        and, given `best_checkpoint_path`, a checkpoint written there."""
        opts = self.opts
        source = (self.train_iter if opts.prefetch_batches <= 0
                  else _Prefetcher(self.train_iter, opts.prefetch_batches).get)
        try:
            while self.global_step < opts.max_steps:
                x, y = source()
                step_no = self.global_step + 1
                fetch = (opts.fetch_every <= 1
                         or step_no % opts.fetch_every == 0
                         or step_no % opts.board_interval == 0
                         or step_no % opts.save_interval == 0
                         or step_no >= opts.max_steps
                         or (self.test_iter is not None
                             and step_no % opts.val_interval == 0))
                loss_dict = self.train_step(x, y, fetch=fetch)
                if callback is not None and fetch:
                    callback(self.global_step, loss_dict)
                if self.test_iter is not None and \
                        self.global_step % opts.val_interval == 0:
                    val = self.validate()
                    if self.best_val_loss is None or \
                            val["loss"] < self.best_val_loss:
                        self.best_val_loss = val["loss"]
                        if best_checkpoint_path is not None:
                            self.save_checkpoint(best_checkpoint_path)
        finally:
            if source is not self.train_iter:
                source.__self__.close()

    def validate(self, n_batches: int = 4) -> Dict[str, float]:
        agg: Dict[str, List[float]] = {}
        stage = self.progressive_stage()
        for _ in range(n_batches):
            x, y = self.test_iter()
            with torch.no_grad():
                _, (loss_dict, _, _) = self._calc_loss(
                    self._trainable(), self._to_device(x), self._to_device(y),
                    stage, self.discriminator_params)
            for k, v in loss_dict.items():
                agg.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in agg.items()}

    # ---------------------------------------------------------- checkpoints

    def _state(self) -> Dict[str, Any]:
        """Every array of the train state, numpy leaves: the params in the
        JAX package's layout, the optimizer states in the port's own."""
        state = {"encoder_params": _to_numpy(self.psp.encoder_params),
                 "decoder_params": _to_numpy(self.psp.decoder_params),
                 "opt_state": _to_numpy(self.optimizer.state_tree())}
        if self.psp.latent_avg is not None:
            state["latent_avg"] = _to_numpy(self.psp.latent_avg)
        if self.discriminator_params is not None:
            state["discriminator_params"] = _to_numpy(
                self.discriminator_params)
            state["d_opt_state"] = _to_numpy(self.d_optimizer.state_tree())
        return state

    def _meta(self) -> Dict[str, Any]:
        return {"global_step": self.global_step,
                "best_val_loss": self.best_val_loss,
                "opts": dataclasses.asdict(self.opts)}

    def save_checkpoint(self, path: str, backend: str = "pickle"):
        """The full train state: params, optimizer states, discriminator and
        step. backend 'pickle' writes one pickle of numpy arrays and plain
        values; 'dir' (the JAX package's 'orbax') a directory of
        coach_meta.json and state.npz, each array under its tree path."""
        state = self._state()
        if backend in ("dir", "orbax"):
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, "state.npz"), **_flatten(state))
            with open(os.path.join(path, "coach_meta.json"), "w") as f:
                json.dump(self._meta(), f)
            return
        import pickle

        state.update(self._meta())
        state.setdefault("latent_avg", None)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, path: str, backend: str = "pickle"):
        """Read a checkpoint `save_checkpoint` wrote (a directory is read as
        the 'dir' backend). The params are written into the coach's tensors
        in place."""
        if backend in ("dir", "orbax") or os.path.isdir(path):
            with np.load(os.path.join(path, "state.npz")) as npz:
                state = _unflatten(dict(npz))
            with open(os.path.join(path, "coach_meta.json")) as f:
                meta = json.load(f)
        else:
            meta = state = load_numpy_pickle(path)
        self.global_step = int(meta["global_step"])
        self.best_val_loss = meta["best_val_loss"]
        self._replicas.clear()
        _copy_into(self.psp.encoder_params, state["encoder_params"])
        _copy_into(self.psp.decoder_params, state["decoder_params"])
        if state.get("latent_avg") is not None:
            self.psp.latent_avg = torch.as_tensor(
                np.asarray(state["latent_avg"], np.float32)).to(self.device)
        self.optimizer.load_state_tree(state["opt_state"], self.device)
        if state.get("discriminator_params") is not None \
                and self.discriminator_params is not None:
            _copy_into(self.discriminator_params,
                       state["discriminator_params"])
            self.d_optimizer.load_state_tree(state["d_opt_state"],
                                             self.device)
