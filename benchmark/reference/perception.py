"""CLIP ViT (image and text towers), ArcFace IR-SE and encoder4editing's
Encoder4Editing in plain PyTorch, as published (OpenAI's clip/model.py,
InsightFace's IR-SE, e4e's psp_encoders.py), reading weights in the port's
param layout (keys only). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# ------------------------------------------------------------ CLIP


def _ln(p, x):
    return F.layer_norm(x, x.shape[-1:], p["weight"], p["bias"], 1e-5)


def _attention(p, x, heads: int, causal: bool):
    n, length, d = x.shape
    q, k, v = F.linear(x, p["in_proj_weight"], p["in_proj_bias"]).chunk(3, -1)
    hd = d // heads

    def split(t):
        return t.reshape(n, length, heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(length, length, dtype=torch.bool,
                          device=x.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = (scores.softmax(dim=-1) @ v).transpose(1, 2).reshape(n, length, d)
    return F.linear(out, p["out_proj"]["weight"], p["out_proj"]["bias"])


def _transformer(p, x, layers: int, heads: int, causal: bool):
    for i in range(layers):
        b = p[f"resblock{i}"]
        x = x + _attention(b["attn"], _ln(b["ln_1"], x), heads, causal)
        h = F.linear(_ln(b["ln_2"], x), b["mlp"]["c_fc"]["weight"],
                     b["mlp"]["c_fc"]["bias"])
        h = h * torch.sigmoid(1.702 * h)
        x = x + F.linear(h, b["mlp"]["c_proj"]["weight"],
                         b["mlp"]["c_proj"]["bias"])
    return x


def clip_preprocess(img: torch.Tensor, size: int) -> torch.Tensor:
    """Generator output in [-1, 1] → CLIP's input: to [0, 255], bicubic
    resize of the short side to `size` (torch's, no antialias), centre
    crop, /255, CLIP's normalisation."""
    x = (img * 127.5 + 128.0).clamp(0.0, 255.0)
    h, w = x.shape[-2:]
    if h <= w:
        oh, ow = size, max(1, int(round(w * size / h)))
    else:
        oh, ow = max(1, int(round(h * size / w))), size
    x = F.interpolate(x, size=(oh, ow), mode="bicubic", align_corners=False)
    top, left = (oh - size) // 2, (ow - size) // 2
    x = x[..., top:top + size, left:left + size]
    mean = torch.tensor(CLIP_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def clip_image(p, c: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """CLIP-normalised images [N, 3, R, R] → image features [N, embed]."""
    v = p["visual"]
    ps = c["vision_patch_size"]
    x = F.conv2d(x, v["conv1_weight"], stride=ps)
    x = x.flatten(2).transpose(1, 2)
    cls = v["class_embedding"][None, None].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"][None]
    x = _ln(v["ln_pre"], x)
    x = _transformer(v["transformer"], x, c["vision_layers"],
                     c["vision_width"] // 64, causal=False)
    return _ln(v["ln_post"], x[:, 0]) @ v["proj"]


def clip_text(p, c: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
    """Token ids [N, context] → text features [N, embed] (the EOT token's,
    the largest id of each row)."""
    x = p["token_embedding"][tokens] + p["positional_embedding"][None]
    x = _transformer(p["transformer"], x, c["transformer_layers"],
                     c["transformer_width"] // 64, causal=True)
    x = _ln(p["ln_final"], x)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return x @ p["text_projection"]


# ------------------------------------------------------------ IR-SE


def _bn(p, x):
    return F.batch_norm(x, p["running_mean"], p["running_var"],
                        p.get("weight"), p.get("bias"), False, 0.0, 1e-5)


def irse_body(p, x, layout: Sequence[Tuple[int, int, int]],
              taps: Sequence[int] = ()):
    """The IR-SE trunk: → (last output, [outputs of bottlenecks `taps`])."""
    x = F.prelu(_bn(p["input_bn"], F.conv2d(x, p["input_conv_weight"],
                                            padding=1)), p["input_prelu"])
    tapped = []
    for i, (in_c, depth, stride) in enumerate(layout):
        b = p["body"][f"{i}"]
        if in_c == depth:
            short = F.max_pool2d(x, 1, stride)
        else:
            short = _bn(b["shortcut_bn"], F.conv2d(
                x, b["shortcut_conv_weight"], stride=stride))
        r = F.conv2d(_bn(b["bn1"], x), b["conv1_weight"], padding=1)
        r = F.prelu(r, b["prelu"])
        r = _bn(b["bn2"], F.conv2d(r, b["conv2_weight"], stride=stride,
                                   padding=1))
        gate = F.adaptive_avg_pool2d(r, 1)
        gate = torch.sigmoid(F.conv2d(F.relu(F.conv2d(
            gate, b["se"]["fc1_weight"])), b["se"]["fc2_weight"]))
        x = r * gate + short
        if i in taps:
            tapped.append(x)
    return x, tapped


def arcface(p, layout, img: torch.Tensor) -> torch.Tensor:
    """StyleMC's identity features: [-1, 1] images → pooled to 256² when
    not already, crop rows 35:223 and columns 32:220, pool to 112², the
    IR-SE embedding, L2-normalised."""
    x = img if img.shape[-1] == 256 else F.adaptive_avg_pool2d(img, 256)
    x = F.adaptive_avg_pool2d(x[:, :, 35:223, 32:220], 112)
    x, _ = irse_body(p, x, layout)
    x = _bn(p["output_bn"], x).flatten(1)
    x = F.linear(x, p["output_linear"]["weight"], p["output_linear"]["bias"])
    x = _bn(p["output_bn1d"], x)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


# ------------------------------------------------------------ e4e


def _head(hp, x, spatial: int):
    for j in range(int(math.log2(spatial))):
        x = F.leaky_relu(F.conv2d(x, hp[f"conv{j}"]["weight"],
                                  hp[f"conv{j}"]["bias"], stride=2,
                                  padding=1), 0.01)
    lin = hp["linear"]
    return F.linear(x.flatten(1), lin["weight"] / math.sqrt(
        lin["weight"].shape[1]), lin["bias"])


def e4e_codes(p, layout, taps, x: torch.Tensor, n_styles: int,
              latent_avg: torch.Tensor) -> torch.Tensor:
    """Encoder4Editing at inference (every progressive stage on): photos
    in [-1, 1] → W+ codes [N, n_styles, 512], plus latent_avg. Row 0 is w0
    from c3; row i adds head i's delta, read from c3 (i < 3), the FPN's p2
    (i < 7) or p1."""
    _, (c1, c2, c3) = irse_body(p, x, layout, taps)

    def lat(name, c):
        return F.conv2d(c, p[name]["weight"], p[name]["bias"])

    def up_add(a, b):
        return F.interpolate(a, size=b.shape[-2:], mode="bilinear",
                             align_corners=True) + b

    p2 = up_add(c3, lat("latlayer1", c2))
    p1 = up_add(p2, lat("latlayer2", c1))
    w0 = _head(p["styles"]["0"], c3, 16)
    rows = [w0]
    for i in range(1, n_styles):
        feat, spatial = (c3, 16) if i < 3 else (p2, 32) if i < 7 else (p1, 64)
        rows.append(w0 + _head(p["styles"][f"{i}"], feat, spatial))
    return torch.stack(rows, dim=1) + latent_avg[None]
