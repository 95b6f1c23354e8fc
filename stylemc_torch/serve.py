"""Batch edit serving (counterpart of `stylemc_tpu/serve.py`).

Device-resident weights, power-of-two batch buckets, uint8 NHWC output made
on the device, and chunked rendering whose device→host copies overlap the
next chunk's compute.

Usage:
    editor = BatchEditor.from_files(network="ffhq.npz",
                                    direction="runs/m2f/direction_x.npz")
    imgs_u8 = editor.edit_seeds([1, 2, 3], change_power=2.0)
    pairs_u8 = editor.edit_styles(styles, change_power=1.5, pairs=True)

A latent mapper in place of a direction (per-item directions, computed
for each chunk from its own styles):
    editor = BatchEditor.from_files(network="ffhq.npz",
                                    mapper="out/mapper_a_smiling_face.pth")

Several devices (a 1-axis `parallel.DataMesh`): weights replicate once per
distinct device, and a bucket the mesh size divides renders as one shard
per device, assembled in request order; a smaller bucket renders on the
editor's device:
    editor = BatchEditor.from_files(network="ffhq.npz", direction=...,
                                    mesh=data_mesh(max_size=64))

Real photos (an e4e inverter attached):
    editor = BatchEditor.from_files(network="decoder.pt", direction=...,
                                    e4e_ckpt="e4e_ffhq_encode.pt")
    edits_u8 = editor.edit_images(photos_u8_nhwc, change_power=2.0)

DeepLab feature blending (a face parser attached; the reference's
--use_blending): each bucket renders its originals and edits, is parsed in
one network call per batch, and renders its edits again blended:
    editor.attach_segmenter(default_segmenter(device=editor.device))
    edits_u8 = editor.edit_images(photos_u8_nhwc, direction_name="smile")
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert import params_from_numpy
from .device import DeviceLike, disable_tf32, host_later, resolve_device
from .edit import (N_STYLE_CHANNELS, STYLE_DIM, blend_edits,
                   mapper_directions_batched, needs_earring_mask, to_u8_nhwc)
from .models.stylegan2.generator import (GeneratorConfig, mapping,
                                         synthesis, w_to_s)
from .parallel.mesh import as_mesh, replicate, shard_batch
from .utils.profiling import add_span, current_span, record_function


def _apply_precision(cfg: GeneratorConfig, precision: str) -> GeneratorConfig:
    """Serving precision policy. 'fp32' = parity with the offline pipeline;
    'bf16-upper' = bfloat16 on the top num_fp16_res blocks; 'bf16' = every
    block bfloat16."""
    if precision == "fp32":
        return dataclasses.replace(cfg, low_precision_dtype="float32")
    if precision == "bf16-upper":
        return dataclasses.replace(cfg, low_precision_dtype="bfloat16")
    if precision == "bf16":
        return dataclasses.replace(
            cfg, low_precision_dtype="bfloat16",
            num_fp16_res=len(cfg.block_resolutions))
    raise ValueError(f"unknown precision {precision!r}; "
                     "expected fp32 | bf16-upper | bf16")


class BatchEditor:
    """Seed/style → edited-image service on one device.

    Batch sizes bucket to powers of two up to `max_batch`, padded with the
    last row. With precision 'fp32' on a CUDA device the constructor turns
    TF32 off for cuDNN convolutions and matmuls (process-wide torch flags):
    cuDNN convolutions run in TF32 by default, which drifts from fp32.
    """

    def __init__(self, gen_cfg: GeneratorConfig, gen_params,
                 direction: Optional[np.ndarray] = None,
                 mapper_params=None, mapper_neg_slope: float = 0.01,
                 mapper_whitelist: bool = False,
                 max_batch: int = 64, truncation_psi: float = 0.7,
                 noise_mode: str = "const", precision: str = "fp32",
                 mesh=None, pipeline_chunk: int = 16,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.precision = precision
        self.cfg = _apply_precision(gen_cfg, precision)
        if precision == "fp32":
            disable_tf32(self.device)
        self.params = params_from_numpy(gen_params, self.device)
        # mesh: a 1-axis DataMesh; buckets it divides render sharded
        self.mesh = as_mesh(mesh)
        self._replicas = None if self.mesh is None else \
            replicate(self.params, self.mesh)
        self.direction = None if direction is None else self._on_device(
            direction)
        # named directions, selected per request
        self.directions: Dict[str, torch.Tensor] = {}
        # a Mapper or its reference state dict: with no direction name, each
        # chunk's directions come from its own styles
        self.mapper_params = None
        if mapper_params is not None:
            from .models.mapper import as_mapper

            self.mapper_params = as_mapper(mapper_params, self.device)
            self.mapper_params.requires_grad_(False)
        self.mapper_neg_slope = mapper_neg_slope
        # the mapper's directions with |δ| < 0.1 and the stoplist zeroed
        self.mapper_whitelist = mapper_whitelist
        self.truncation_psi = truncation_psi
        self.noise_mode = noise_mode
        self._inverter = None  # set by attach_inverter
        self._segmenter = None  # set by attach_segmenter
        self._edit_generator = None  # set by attach_segmenter
        self.buckets = [b for b in (1, 2, 4, 8, 16, 32, 64) if b <= max_batch]
        # Large requests render in pipeline_chunk sub-batches; each chunk's
        # uint8 result is copied to pinned host memory asynchronously, so the
        # next chunk's compute overlaps it. At most max_inflight_chunks
        # chunks are in flight, which bounds device memory for any request
        # size. 0 disables chunking.
        self.pipeline_chunk = pipeline_chunk
        self.max_inflight_chunks = 4

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------- plumbing

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def _pad(self, x: torch.Tensor, b: int) -> torch.Tensor:
        n = x.shape[0]
        if n == b:
            return x
        return torch.cat([x, x[-1:].expand(b - n, *x.shape[1:])], dim=0)

    def _sharded_ok(self, n: int) -> bool:
        return self.mesh is not None and n % self.mesh.size == 0

    def _sharded(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn(params, rows) over the mesh when it divides the rows (each
        shard on its device, the rows back on the editor's device in
        order), else on the editor's device."""
        if not self._sharded_ok(x.shape[0]):
            return fn(self.params, x)
        return torch.cat([fn(self._replicas[d], xs).to(self.device)
                          for d, xs in zip(self.mesh.devices,
                                           shard_batch(self.mesh, x))])

    def _render_u8(self, s: torch.Tensor) -> torch.Tensor:
        return self._sharded(lambda gp, x: to_u8_nhwc(synthesis(
            gp, self.cfg, x, noise_mode=self.noise_mode)), s)

    def _styles_from_z(self, z: torch.Tensor) -> torch.Tensor:
        return self._sharded(lambda gp, x: w_to_s(gp, self.cfg, mapping(
            gp, self.cfg, x, truncation_psi=self.truncation_psi)), z)

    def add_direction(self, name: str, direction) -> None:
        """Register a named direction for per-request selection."""
        self.directions[name] = self._on_device(direction)

    def attach_inverter(self, psp) -> None:
        """Enable real-image serving: uint8 photos → e4e W+ codes → this
        generator's S space → edit → render, the composition of the
        offline infer_e4e → w_s_converter → generate_fromS chain. The pSp
        decoder is not used: codes become styles through the editor's own
        generator, so named directions apply unchanged.

        psp: a `models.e4e.psp.PSP` whose stylegan_size is this editor's
        generator resolution."""
        if psp.cfg.stylegan_size != self.cfg.img_resolution:
            raise ValueError(
                f"e4e encoder trained for {psp.cfg.stylegan_size}px, "
                f"editor generator is {self.cfg.img_resolution}px")
        # only encode() runs here: keep no decoder params on the device
        self._inverter = dataclasses.replace(
            psp, encoder_params=params_from_numpy(psp.encoder_params,
                                                  self.device),
            decoder_params={},
            latent_avg=None if psp.latent_avg is None
            else torch.as_tensor(psp.latent_avg, dtype=torch.float32,
                                 device=self.device))

    @property
    def has_inverter(self) -> bool:
        return self._inverter is not None

    def attach_segmenter(self, segmenter,
                         edit_generator: Optional[Tuple] = None) -> None:
        """Blend every edit with DeepLab feature blending (the reference's
        --use_blending; `edit.blend_edits`): per bucket, the originals and
        the edits are rendered, each batch is parsed in one network call,
        and the edits are rendered again with their 32² and 64² features
        blended toward the originals' under the earring, background and
        teeth masks. Blended buckets render on the editor's device.

        segmenter: a `models.deeplab.Segmenter`; edit_generator: (params,
        cfg) of a second generator that renders the edits and their blend
        (generate_fromS --network2)."""
        self._segmenter = segmenter
        self._edit_generator = None if edit_generator is None else (
            params_from_numpy(edit_generator[0], self.device),
            _apply_precision(edit_generator[1], self.precision))

    @torch.inference_mode()
    def invert_images(self, images_u8) -> torch.Tensor:
        """uint8 NHWC photos (256² for an e4e_ffhq_encode encoder) → S-space
        styles [N, 26, 512] on the device, in bucketed, padded chunks of at
        most max_batch. The uint8 → [-1, 1] map is x/127.5 - 1 (the e4e
        eval transform)."""
        if self._inverter is None:
            raise ValueError("no inverter attached (attach_inverter / "
                             "--e4e_ckpt)")
        x = images_u8 if isinstance(images_u8, torch.Tensor) \
            else torch.from_numpy(np.array(images_u8))
        if x.dtype != torch.uint8 or x.ndim != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 [N,H,W,3], got {x.dtype} "
                             f"{tuple(x.shape)}")
        outs = []
        for lo in range(0, x.shape[0], self.buckets[-1]):
            chunk = x[lo:lo + self.buckets[-1]].to(self.device)
            n = chunk.shape[0]
            chunk = self._pad(chunk, self._bucket(n))
            img = chunk.permute(0, 3, 1, 2).float() / 127.5 - 1.0
            codes = self._inverter.encode(img)
            outs.append(w_to_s(self.params, self.cfg, codes)[:n])
        return torch.cat(outs, dim=0)

    def edit_images(self, images_u8, change_power: float = 2.0,
                    pairs: bool = False,
                    direction_name: Optional[str] = None,
                    prompt: Optional[str] = None) -> np.ndarray:
        """Real photos in, edited renders out; pairs=True returns
        [reconstruction | edited], the offline pipeline's two panels."""
        return self.edit_styles(self.invert_images(images_u8),
                                change_power=change_power, pairs=pairs,
                                direction_name=direction_name, prompt=prompt)

    def _directions_for(self, styles: torch.Tensor,
                        name: Optional[str] = None) -> torch.Tensor:
        """The named direction, else the mapper's directions of `styles`,
        else the constructor's direction."""
        if name is not None:
            if name not in self.directions:
                raise KeyError(f"unknown direction {name!r}; loaded: "
                               f"{sorted(self.directions)}")
            return self.directions[name]
        if self.mapper_params is not None:
            return mapper_directions_batched(
                self.mapper_params, styles, neg_slope=self.mapper_neg_slope,
                use_whitelist=self.mapper_whitelist)
        if self.direction is None:
            raise ValueError("no direction or mapper loaded")
        return self.direction

    # -------------------------------------------------------------- public

    @torch.inference_mode()
    def styles_from_seeds(self, seeds: Sequence[int]) -> torch.Tensor:
        """Seeds → styles [N, 26, 512] on the device; z for seed s is
        np.random.RandomState(s).randn(1, z_dim)."""
        with record_function("editor.styles", rows=len(seeds)):
            zs = np.concatenate(
                [np.random.RandomState(s).randn(1, self.cfg.z_dim)
                 for s in seeds]).astype(np.float32)
            out = []
            for lo in range(0, len(seeds), self.buckets[-1]):
                chunk = torch.from_numpy(zs[lo:lo + self.buckets[-1]]).to(
                    self.device)
                z = self._pad(chunk, self._bucket(chunk.shape[0]))
                out.append(self._styles_from_z(z)[:chunk.shape[0]])
            return torch.cat(out, dim=0)

    @torch.inference_mode()
    def edit_styles(self, styles, change_power: float = 2.0,
                    pairs: bool = False,
                    direction_name: Optional[str] = None,
                    prompt: Optional[str] = None) -> np.ndarray:
        """styles [N, 26, 512] → uint8 [N, H, W, 3]; pairs=True returns
        [orig | edited] side by side; direction_name selects a named
        direction (default: the mapper's, else the constructor's). With a
        face parser attached the edits are blended; `prompt` (default: the
        direction's name) decides the earring mask, none for a prompt
        that contains 'face of a man'."""
        styles = torch.as_tensor(styles, dtype=torch.float32,
                                 device=self.device)
        need_earring = needs_earring_mask(prompt or direction_name or "")
        step = min(self.pipeline_chunk or self.buckets[-1], self.buckets[-1])
        pending: List[Tuple[int, Callable[[], np.ndarray]]] = []
        outs: List[np.ndarray] = []

        def fetch(n, host):
            with record_function("editor.fetch", rows=n):
                outs.append(host()[:n])

        for lo in range(0, styles.shape[0], step):
            chunk = styles[lo:lo + step]
            n = chunk.shape[0]
            padded = self._pad(chunk, self._bucket(n))
            with record_function("editor.render", rows=n,
                                 bucket=padded.shape[0]):
                d = self._directions_for(padded, direction_name)
                if self._segmenter is None:
                    img = self._render_u8(padded + d * change_power)
                    orig = self._render_u8(padded) if pairs else None
                else:
                    orig, img = blend_edits(
                        self.params, self.cfg, padded,
                        padded + d * change_power, self._segmenter,
                        [need_earring] * padded.shape[0],
                        noise_mode=self.noise_mode,
                        gen2=self._edit_generator)
                if pairs:
                    img = torch.cat([orig, img], dim=2)
                pending.append((n, host_later(img)))
            if len(pending) >= max(1, self.max_inflight_chunks):
                fetch(*pending.pop(0))
        for item in pending:
            fetch(*item)
        return np.concatenate(outs, axis=0)

    def edit_seeds(self, seeds: Sequence[int], change_power: float = 2.0,
                   pairs: bool = False,
                   direction_name: Optional[str] = None) -> np.ndarray:
        return self.edit_styles(self.styles_from_seeds(seeds),
                                change_power=change_power, pairs=pairs,
                                direction_name=direction_name)

    def warmup(self):
        """Render every bucket a request can reach once (chunks of
        pipeline_chunk pad up to their bucket), and invert every bucket when
        an inverter is attached, so first requests pay no kernel build or
        library initialisation."""
        step = min(self.pipeline_chunk or self.buckets[-1], self.buckets[-1])
        top = self._bucket(step)
        for b in self.buckets:
            if b > top:
                break
            s = torch.zeros((b, N_STYLE_CHANNELS, STYLE_DIM),
                            device=self.device)
            self.edit_styles(s, change_power=0.0)
        if self._inverter is not None:
            for b in self.buckets:
                self.invert_images(np.zeros((b, 256, 256, 3), np.uint8))

    # ------------------------------------------------------------- loading

    @classmethod
    def from_files(cls, network: str, direction: Optional[str] = None,
                   mapper: Optional[str] = None,
                   directions: Optional[Dict[str, str]] = None,
                   e4e_ckpt: Optional[str] = None,
                   **kwargs) -> "BatchEditor":
        """network: NVIDIA .pkl, native .npz or rosinality .pt; direction:
        npz with key 's'; mapper: a mapper_{prompt}.pth state dict;
        directions: {name: path} registers named directions; e4e_ckpt attaches a real-image inverter (edit_images,
        POST /edit_image)."""
        from .io import load_generator

        device = resolve_device(kwargs.pop("device", None))
        cfg, params = load_generator(network, device=device)
        d = np.load(direction)["s"] if direction else None
        mp = None
        if mapper:
            from .models.mapper import load_mapper

            mp = load_mapper(mapper, device=device)
        editor = cls(cfg, params, direction=d, mapper_params=mp,
                     device=device, **kwargs)
        for name, path in (directions or {}).items():
            editor.add_direction(name, np.load(path)["s"])
        if e4e_ckpt:
            from .models.e4e.psp import load_psp_from_checkpoint
            editor.attach_inverter(load_psp_from_checkpoint(
                e4e_ckpt, stylegan_size=cfg.img_resolution, device=device))
        return editor


class CoalescingDispatcher:
    """Merge concurrent same-parameter requests into one batched dispatch.

    Submissions enqueue and block; one worker thread drains the queue,
    groups items by `key` (only identical parameters may share a call),
    concatenates each group along axis 0, runs ONE editor call, and splits
    the result back to the waiting submitters. The first item of a drain
    waits up to max_wait_ms for company; a full bucket dispatches at once.

    The worker is also the single device owner: all device work of the
    coalesced path is issued from its thread.

    Each submission's wait, from `submit` to the start of the call that
    carries it, is kept for the last 1000 submissions (`wait_ms()`), and
    recorded as a `dispatch.wait` span while the recorder is on.
    """

    _STOP = object()

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 3.0):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self.batched_calls = 0
        self.coalesced_items = 0
        self._waits_ns: "collections.deque[int]" = collections.deque(
            maxlen=1000)
        self._waits_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="coalescing-dispatcher")
        self._worker.start()

    def submit(self, key, rows: np.ndarray, fn,
               request: Optional[int] = None) -> np.ndarray:
        """Block until `fn` ran on a batch containing `rows`; returns this
        submission's slice of the result. `fn` must map a [N, ...] batch to
        [N, ...] results and be the same for every submission with the
        same `key`. `request` tags the submission's spans."""
        item = {"key": key, "rows": rows, "fn": fn,
                "ev": threading.Event(), "out": None, "err": None,
                "t": time.perf_counter_ns(), "request": request,
                "thread": threading.get_native_id(),
                "parent": current_span()}
        self._q.put(item)
        item["ev"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self):
        self._q.put(self._STOP)
        self._worker.join(timeout=5)

    def wait_ms(self) -> np.ndarray:
        """The queue waits (ms) of the last 1000 submissions a call
        carried."""
        with self._waits_lock:
            return np.asarray(self._waits_ns, np.float64) / 1e6

    # ------------------------------------------------------------ internal

    def _drain(self, first) -> list:
        """Collect items for up to max_wait_s / max_batch rows."""
        batch = [first]
        rows = first["rows"].shape[0]
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is self._STOP:
                self._q.put(item)  # re-deliver to the loop
                break
            batch.append(item)
            rows += item["rows"].shape[0]
        return batch

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            with record_function("dispatch.drain"):
                batch = self._drain(item)
            groups: Dict = {}
            for it in batch:
                groups.setdefault(it["key"], []).append(it)
            for index, items in enumerate(groups.values()):
                self._call(index, items)

    def _call(self, index: int, items: list) -> None:
        """One editor call on the group's rows (`index`: the group's place
        in its drain), each submitter woken with its slice or the error."""
        start = time.perf_counter_ns()
        call = None
        try:
            with record_function(
                    "dispatch.call",
                    rows=sum(it["rows"].shape[0] for it in items),
                    key=index, requests=tuple(it["request"] for it in items
                                              if it["request"] is not None)
            ) as call:
                rows = np.concatenate([it["rows"] for it in items], axis=0)
                out = items[0]["fn"](rows)
            self.batched_calls += 1
            self.coalesced_items += len(items)
            lo = 0
            for it in items:
                n = it["rows"].shape[0]
                it["out"] = out[lo:lo + n]
                lo += n
        except Exception as e:  # noqa: BLE001 — deliver to callers
            for it in items:
                it["err"] = e
        finally:
            with self._waits_lock:
                self._waits_ns.extend(start - it["t"] for it in items)
            for it in items:
                add_span("dispatch.wait", it["t"], start, it["thread"],
                         it["parent"], it["request"], call=call)
                it["ev"].set()
