"""Seeded weights made on the device, in the port's native param layout.

Every model's weights come from one standard normal draw of a CUDA (or,
in the CPU tests, a CPU) `torch.Generator` seeded from the run's seed and
the model's name: one large `torch.randn` per model, carved into views and
scaled. Nothing is drawn leaf by leaf, on the host, or written to disk,
and nothing here calls the port's initialisers. The layouts are the port's
(`stylemc_torch/models/...` docstrings); the scales are each family's
published initialisation, with the changes listed under `assumed` in the
configuration files.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Tuple

import torch

from ..reference.stylegan2 import block_resolutions, channels


def model_seed(seed: int, name: str) -> int:
    """A 63-bit seed for model `name` of run `seed` (any whole number)."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator_on(device: torch.device, seed: int, name: str
                 ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(model_seed(seed, name))


class _Plan:
    """Leaves of one model: normal leaves share one draw, constants are
    filled once."""

    def __init__(self):
        self.normal: List[Tuple[Tuple[str, ...], Tuple[int, ...], float]] = []
        self.const: List[Tuple[Tuple[str, ...], Tuple[int, ...], float]] = []

    def randn(self, path, shape, std=1.0):
        self.normal.append((tuple(path), tuple(shape), float(std)))

    def full(self, path, shape, value):
        self.const.append((tuple(path), tuple(shape), float(value)))

    def build(self, device, gen: torch.Generator) -> Dict[str, Any]:
        total = sum(math.prod(s) for _, s, _ in self.normal)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=torch.float32)
        tree: Dict[str, Any] = {}
        at = 0
        for path, shape, std in self.normal:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            if std != 1.0:
                leaf.mul_(std)
            _put(tree, path, leaf)
            at += n
        for path, shape, value in self.const:
            _put(tree, path, torch.full(shape, value, device=device))
        return tree


def _put(tree, path, leaf):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


# ------------------------------------------------------------ StyleGAN2


def stylegan2_plan(g: Dict[str, Any]) -> _Plan:
    """StyleGAN2-ADA's scheme: unit-normal weights (mapping weights stored
    divided by the learning-rate multiplier), affine biases 1. Conv biases
    and noise strengths, zero at ADA's init and learned later, are drawn
    small so that their paths carry values; ToRGB weights are scaled by
    `torgb_scale` (configuration files, `assumed`)."""
    p = _Plan()
    lr = g["mapping_lr_multiplier"]
    w_dim = g["w_dim"]
    for i in range(g["mapping_layers"]):
        p.randn(("mapping", f"fc{i}", "weight"),
                (w_dim, g["z_dim"] if i == 0 else w_dim), 1.0 / lr)
        p.full(("mapping", f"fc{i}", "bias"), (w_dim,), 0.0)
    p.full(("mapping", "w_avg"), (w_dim,), 0.0)

    def layer(path, c_in, c_out, res):
        p.randn(path + ("affine", "weight"), (c_in, w_dim))
        p.full(path + ("affine", "bias"), (c_in,), 1.0)
        p.randn(path + ("weight",), (c_out, c_in, 3, 3))
        p.randn(path + ("bias",), (c_out,), g["bias_std"])
        p.randn(path + ("noise_strength",), (), g["noise_strength_std"])
        p.randn(path + ("noise_const",), (res, res))

    for res in block_resolutions(g):
        c_out = channels(g, res)
        c_in = channels(g, res // 2) if res > 4 else c_out
        base = ("synthesis", f"b{res}")
        if res == 4:
            p.randn(base + ("const",), (c_out, 4, 4))
        else:
            layer(base + ("conv0",), c_in, c_out, res)
        layer(base + ("conv1",), c_out, c_out, res)
        p.randn(base + ("torgb", "affine", "weight"), (c_out, w_dim))
        p.full(base + ("torgb", "affine", "bias"), (c_out,), 1.0)
        p.randn(base + ("torgb", "weight"), (g["img_channels"], c_out, 1, 1),
                g["torgb_scale"])
        p.full(base + ("torgb", "bias"), (g["img_channels"],), 0.0)
    return p


# ------------------------------------------------------------ CLIP ViT


def clip_plan(c: Dict[str, Any]) -> _Plan:
    """OpenAI CLIP's ViT scheme (clip/model.py `initialize_parameters`):
    attention in-projections std width^-0.5, out-projections and c_proj
    width^-0.5 (2·layers)^-0.5, c_fc (2·width)^-0.5, token embedding 0.02,
    text positions 0.01, LayerNorms at one and zero."""
    p = _Plan()

    def block(path, d, layers):
        proj_std = d ** -0.5 * (2 * layers) ** -0.5
        p.randn(path + ("attn", "in_proj_weight"), (3 * d, d), d ** -0.5)
        p.full(path + ("attn", "in_proj_bias"), (3 * d,), 0.0)
        p.randn(path + ("attn", "out_proj", "weight"), (d, d), proj_std)
        p.full(path + ("attn", "out_proj", "bias"), (d,), 0.0)
        for ln in ("ln_1", "ln_2"):
            p.full(path + (ln, "weight"), (d,), 1.0)
            p.full(path + (ln, "bias"), (d,), 0.0)
        p.randn(path + ("mlp", "c_fc", "weight"), (4 * d, d), (2 * d) ** -0.5)
        p.full(path + ("mlp", "c_fc", "bias"), (4 * d,), 0.0)
        p.randn(path + ("mlp", "c_proj", "weight"), (d, 4 * d), proj_std)
        p.full(path + ("mlp", "c_proj", "bias"), (d,), 0.0)

    w, ps, res = c["vision_width"], c["vision_patch_size"], \
        c["image_resolution"]
    grid = res // ps
    v = ("visual",)
    p.randn(v + ("conv1_weight",), (w, 3, ps, ps), w ** -0.5)
    p.randn(v + ("class_embedding",), (w,), w ** -0.5)
    p.randn(v + ("positional_embedding",), (grid * grid + 1, w), w ** -0.5)
    for ln in ("ln_pre", "ln_post"):
        p.full(v + (ln, "weight"), (w,), 1.0)
        p.full(v + (ln, "bias"), (w,), 0.0)
    p.randn(v + ("proj",), (w, c["embed_dim"]), w ** -0.5)
    for i in range(c["vision_layers"]):
        block(v + ("transformer", f"resblock{i}"), w, c["vision_layers"])
    tw = c["transformer_width"]
    p.randn(("token_embedding",), (c["vocab_size"], tw), 0.02)
    p.randn(("positional_embedding",), (c["context_length"], tw), 0.01)
    for i in range(c["transformer_layers"]):
        block(("transformer", f"resblock{i}"), tw, c["transformer_layers"])
    p.full(("ln_final", "weight"), (tw,), 1.0)
    p.full(("ln_final", "bias"), (tw,), 0.0)
    p.randn(("text_projection",), (tw, c["embed_dim"]), tw ** -0.5)
    p.full(("logit_scale",), (), math.log(1 / 0.07))
    return p


# ------------------------------------------------------------ IR-SE body


def ir_se_layout(units, widths, stem: int) -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck: stage k has units[k]
    bottlenecks of widths[k] channels, the first with stride 2."""
    out, c = [], stem
    for n, d in zip(units, widths):
        out.append((c, d, 2))
        out.extend((d, d, 1) for _ in range(n - 1))
        c = d
    return out


def _bn(p: _Plan, path, c):
    p.full(path + ("weight",), (c,), 1.0)
    p.full(path + ("bias",), (c,), 0.0)
    p.full(path + ("running_mean",), (c,), 0.0)
    p.full(path + ("running_var",), (c,), 1.0)


def irse_body_plan(p: _Plan, layout, stem: int, se_gate_std: float):
    """The InsightFace IR-SE trunk: He-normal convolutions, BatchNorm at
    its identity statistics, PReLU 0.25; the SE gate's second weight drawn
    at `se_gate_std` of He so that the gate varies with its input."""
    def he(path, shape, scale=1.0):
        p.randn(path, shape, scale * math.sqrt(2.0 / math.prod(shape[1:])))

    he(("input_conv_weight",), (stem, 3, 3, 3))
    _bn(p, ("input_bn",), stem)
    p.full(("input_prelu",), (stem,), 0.25)
    for i, (in_c, depth, _) in enumerate(layout):
        b = ("body", f"{i}")
        _bn(p, b + ("bn1",), in_c)
        he(b + ("conv1_weight",), (depth, in_c, 3, 3))
        p.full(b + ("prelu",), (depth,), 0.25)
        he(b + ("conv2_weight",), (depth, depth, 3, 3))
        _bn(p, b + ("bn2",), depth)
        mid = max(depth // 16, 1)
        he(b + ("se", "fc1_weight"), (mid, depth, 1, 1))
        he(b + ("se", "fc2_weight"), (depth, mid, 1, 1), se_gate_std)
        if in_c != depth:
            he(b + ("shortcut_conv_weight",), (depth, in_c, 1, 1))
            _bn(p, b + ("shortcut_bn",), depth)


def arcface_plan(a: Dict[str, Any]) -> Tuple[_Plan, list]:
    layout = ir_se_layout(a["units"], a["widths"], a["stem"])
    p = _Plan()
    irse_body_plan(p, layout, a["stem"], a["se_gate_std"])
    final = layout[-1][1]
    feat = a["input_size"] // 2 ** len(a["units"])
    _bn(p, ("output_bn",), final)
    p.randn(("output_linear", "weight"), (a["embed"], final * feat * feat),
            0.01)
    p.full(("output_linear", "bias"), (a["embed"],), 0.0)
    p.full(("output_bn1d", "running_mean"), (a["embed"],), 0.0)
    p.full(("output_bn1d", "running_var"), (a["embed"],), 1.0)
    return p, layout


# ------------------------------------------------------------ e4e


def e4e_taps(layout) -> Tuple[int, int, int]:
    """The last bottleneck of each of the last three stages (IR-50:
    6/20/23): the FPN's c1, c2, c3."""
    starts = [i for i, (_, _, s) in enumerate(layout) if s == 2]
    ends = [s - 1 for s in starts[1:]] + [len(layout) - 1]
    return tuple(ends[-3:])


def head_spatial(i: int) -> int:
    """Encoder4Editing's style heads: rows 0-2 read c3 (16²), 3-6 the FPN's
    p2 (32²), 7+ p1 (64²)."""
    return 16 if i < 3 else 32 if i < 7 else 64


def e4e_plan(e: Dict[str, Any], n_styles: int) -> Tuple[_Plan, list]:
    """encoder4editing's Encoder4Editing: the IR-SE trunk, the FPN's 1x1
    lateral convs and one GradualStyleBlock per W+ row (stride-2 3x3 convs
    at PyTorch's default init bound, an EqualLinear at unit normal)."""
    layout = ir_se_layout(e["units"], e["widths"], e["stem"])
    p = _Plan()
    irse_body_plan(p, layout, e["stem"], e["se_gate_std"])
    t1, t2, t3 = e4e_taps(layout)
    c1, c2, c3 = layout[t1][1], layout[t2][1], layout[t3][1]

    def conv(path, cin, cout, k):
        p.randn(path + ("weight",), (cout, cin, k, k),
                1.0 / math.sqrt(3 * cin * k * k))
        p.full(path + ("bias",), (cout,), 0.0)

    for i in range(n_styles):
        h = ("styles", f"{i}")
        for j in range(int(math.log2(head_spatial(i)))):
            conv(h + (f"conv{j}",), c3, c3, 3)
        p.randn(h + ("linear", "weight"), (e["style_dim"], c3))
        p.full(h + ("linear", "bias"), (e["style_dim"],), 0.0)
    conv(("latlayer1",), c2, c3, 1)
    conv(("latlayer2",), c1, c3, 1)
    return p, layout


def make_model(plan: _Plan, device, seed: int, name: str) -> Dict[str, Any]:
    return plan.build(device, generator_on(device, seed, name))
