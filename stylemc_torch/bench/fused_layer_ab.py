"""Fused synthesis layer (B3/B4/B5) against the unfused layer
(`modulated_conv2d` + `bias_act` on cuDNN) on one CUDA card: the A/B that
decides whether the port's generator calls the fused kernels.

    python -m stylemc_torch.bench.fused_layer_ab

Port of `.bench/fused_layer_ab.py`, at every up=1 (conv1) layer of the
full-width FFHQ-256 generator (channel_base 32768, channel_max 512: C = 512
at 4²–64², 256 at 128², 128 at 256²), CI = CO = C, gain √2, clamp 256, one
constant [res, res] noise plane, float32 with TF32 off. Modes:

  fwd          forward, batch 4 (one training step's conv1s)
  fwd_b16      forward, batch 16 (one serving call's conv1s)
  fwd_bwd_xs   forward + backward to x and the styles, batch 4 (the
               find_direction regime, generator frozen: B3 + B4)
  fwd_bwd_w    forward + backward to x, the styles and the weight, batch 4
               (the decoder-training regime: B3 + B4 + B5)

Each layer's fused and unfused times are device times (CUDA events around
calls queued behind a sleep kernel), taken in turns fused, unfused,
unfused, fused; each side's time is the lower of its two. It prints one
JSON line per layer and mode, and one summed line per mode: what wiring
the kernels into conv1 would change in one training step or serving call.
Without a CUDA device it raises.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from stylemc_torch.device import resolve_device
from stylemc_torch.models.stylegan2.generator import GeneratorConfig
from stylemc_torch.ops import bias_act, modulated_conv2d
from stylemc_torch.ops.kernels.modconv import fused_modulated_layer

from .timing import device_ms_for, nvidia_smi_line

GAIN = math.sqrt(2)
CLAMP = 256.0
# fused against unfused: forward max |Δ| over max(1, max |y|), gradients
# relative L2 (cotangent zeroed at `activation_flips`); the two sum in
# other orders in fp32
AB_TOL = 1e-4


@dataclass(frozen=True)
class Mode:
    name: str
    batch: int
    grads: Tuple[str, ...]               # inputs differentiated, of x, s, w
    launches: Tuple[int, int, int]       # B3, B4, B5 per fused call


MODES = (
    Mode("fwd", 4, (), (1, 0, 0)),
    Mode("fwd_b16", 16, (), (1, 0, 0)),
    Mode("fwd_bwd_xs", 4, ("x", "s"), (1, 1, 0)),
    Mode("fwd_bwd_w", 4, ("x", "s", "w"), (1, 1, 1)),
)


def layer_shapes(cfg: Optional[GeneratorConfig] = None
                 ) -> List[Tuple[int, int]]:
    """(C, res) of every conv1 (up=1, C → C) layer of the generator, full
    width FFHQ-256 by default."""
    cfg = cfg or GeneratorConfig(img_resolution=256)
    return [(cfg.channels(res), res) for res in cfg.block_resolutions]


def layer_flop(c: int, res: int, batch: int) -> int:
    """Flops (2 per multiply-add) of one layer's 3x3 convolution."""
    return 2 * batch * c * c * 9 * res * res


def make_inputs(n: int, ci: int, co: int, h: int, w: int, device,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """x [n,ci,h,w], w [co,ci,3,3], s, noise [h,w] and b of one layer,
    drawn on `device` from `seed` with the scales of the JAX package's
    fused-layer tests."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {"x": randn(n, ci, h, w), "w": randn(co, ci, 3, 3) * 0.3,
            "s": randn(n, ci) * 0.7 + 1.0, "noise": randn(h, w) * 0.1,
            "b": randn(co) * 0.2}


def unfused_layer(x, w, s, noise, b):
    y = modulated_conv2d(x, w, s, noise=noise[None, None], up=1, padding=1,
                         flip_weight=True)
    return bias_act(y, b, act="lrelu", gain=GAIN, clamp=CLAMP)


def fused_layer(x, w, s, noise, b):
    return fused_modulated_layer(x, w, s, noise, b, gain=GAIN, clamp=CLAMP)


def step(layer, inputs, mode: Mode, cot: torch.Tensor):
    """One call of `mode` through `layer`: (output,) without autograd, or
    (output, *the gradients of <layer(...), cot> with respect to
    `mode.grads`)."""
    if not mode.grads:
        with torch.no_grad():
            return (layer(**inputs),)
    leaves = {k: v.detach().requires_grad_(k in mode.grads)
              for k, v in inputs.items()}
    y = layer(**leaves)
    grads = torch.autograd.grad(y, [leaves[k] for k in mode.grads], cot)
    return (y.detach(), *grads)


def activation_flips(y_a: torch.Tensor, y_b: torch.Tensor) -> torch.Tensor:
    """Where two evaluations of the layer take different branches of its
    piecewise gradient: the sign of y (lrelu) or whether the clamp binds.
    Two fp32 sums in other orders put an element whose pre-activation lies
    within rounding of 0 or ±clamp on either side, and the gradient there
    jumps (gain against 0.2·gain or 0), so gradients are compared with the
    cotangent zeroed at these elements."""
    return (((y_a >= 0) != (y_b >= 0))
            | ((y_a.abs() >= CLAMP) != (y_b.abs() >= CLAMP)))


def _err(got, want, forward: bool) -> float:
    if forward:
        scale = max(1.0, float(want.abs().max()))
        return float((got - want).abs().max()) / scale
    return float((got - want).norm() / want.norm())


def run_layer(c: int, res: int, mode: Mode, device, seed: int = 0):
    """(row, fused calls made): fused and unfused times of one layer in
    `mode`, their outputs compared."""
    inputs = make_inputs(mode.batch, c, c, res, res, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cot = torch.randn((mode.batch, c, res, res), generator=gen, device=device)
    calls = [0]

    def fused(c=cot):
        calls[0] += 1
        return step(fused_layer, inputs, mode, c)

    def unfused(c=cot):
        return step(unfused_layer, inputs, mode, c)

    out_f, out_u = fused(), unfused()
    flips = activation_flips(out_f[0], out_u[0])
    n_flips = int(flips.sum())
    if mode.grads and n_flips:
        masked = cot.masked_fill(flips, 0.0)
        out_f, out_u = fused(masked), unfused(masked)
    errs = [_err(out_f[0], out_u[0], True)] + [
        _err(g, u, False) for g, u in zip(out_f[1:], out_u[1:])]
    del out_f, out_u
    times = {"fused": [], "unfused": []}
    for side in ("fused", "unfused", "unfused", "fused"):
        times[side].append(device_ms_for(fused if side == "fused"
                                         else unfused))
    # the input gradient costs a second convolution, the weight gradient a
    # third; the style gradient's sums are a small share
    flop = layer_flop(c, res, mode.batch) * (
        1 + ("x" in mode.grads) + ("w" in mode.grads))
    fused_ms, unfused_ms = min(times["fused"]), min(times["unfused"])
    row = {"mode": mode.name, "C": c, "res": res, "batch": mode.batch,
           "fused_ms": fused_ms, "unfused_ms": unfused_ms,
           "fused_samples_ms": times["fused"],
           "unfused_samples_ms": times["unfused"],
           "unfused_over_fused": unfused_ms / fused_ms,
           "flop": flop, "fused_tflop_per_s": flop / fused_ms / 1e9,
           "unfused_tflop_per_s": flop / unfused_ms / 1e9,
           "max_err": max(errs), "activation_flips": n_flips}
    if not max(errs) <= AB_TOL:
        raise AssertionError(f"fused and unfused disagree: {row}")
    return row, calls[0]


def run_mode(mode: Mode, device, layers=None, seed: int = 0):
    """(rows, summed row, fused calls made) of `mode` over `layers`
    (default: every full-width FFHQ-256 conv1)."""
    rows, calls = [], 0
    for c, res in layers or layer_shapes():
        row, n = run_layer(c, res, mode, device, seed)
        rows.append(row)
        calls += n
    fused_ms = sum(r["fused_ms"] for r in rows)
    unfused_ms = sum(r["unfused_ms"] for r in rows)
    flop = sum(r["flop"] for r in rows)
    total = {"mode": mode.name, "batch": mode.batch, "layers": len(rows),
             "fused_ms": fused_ms, "unfused_ms": unfused_ms,
             "wired_minus_unfused_ms": fused_ms - unfused_ms,
             "unfused_over_fused": unfused_ms / fused_ms, "flop": flop,
             "fused_tflop_per_s": flop / fused_ms / 1e9,
             "unfused_tflop_per_s": flop / unfused_ms / 1e9}
    return rows, total, calls


def main() -> int:
    device = resolve_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    print(json.dumps({"device": torch.cuda.get_device_name(device),
                      "nvidia_smi": card, "torch": torch.__version__}),
          flush=True)
    for mode in MODES:
        rows, total, _ = run_mode(mode, device)
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps({"summed": True, "card": card, **total}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
