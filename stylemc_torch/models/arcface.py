"""ArcFace IR-SE backbone (InsightFace) in torch (counterpart of
`stylemc_tpu/models/arcface.py`).

IR-SE-50: 3x3 stem conv + BN + PReLU, four stages of bottleneck_IR_SE units
(BN → 3x3 conv → PReLU → strided 3x3 conv → BN → SE, plus a 1x1-conv/BN or
strided-identity shortcut), then BN → flatten → Linear(512·7·7→512) →
BN1d(affine=False) → L2 normalize. Inference mode (running BN statistics,
dropout off) and differentiable: it is the identity loss of find_direction.
The stem and bottlenecks (`body_apply`) are also the e4e encoders' body.

Functions over a params dict with the JAX package's layout;
`params_from_torch_state` maps the torch Sequential namespace
(body.N.res_layer.M.*) onto it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

Layout = Sequence[Tuple[int, int, int]]


def ir_se_50_layout() -> List[Tuple[int, int, int]]:
    """(in_channel, depth, stride) per bottleneck, IR-50 layout."""
    blocks = []
    for in_c, depth, units in ((64, 64, 3), (64, 128, 4), (128, 256, 14),
                               (256, 512, 3)):
        blocks.append((in_c, depth, 2))
        blocks.extend((depth, depth, 1) for _ in range(units - 1))
    return blocks


def _conv(x, w, stride=1, padding=0):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(p, x, eps=1e-5):
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    bias = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None].to(x.dtype) + \
        bias[None, :, None, None].to(x.dtype)


def _bn1d(p, x, eps=1e-5):
    # `weight`/`bias` are optional (BatchNorm1d(affine=False)); a missing key
    # is an absent parameter, as a None leaf is in the JAX tree
    scale = torch.rsqrt(p["running_var"] + eps)
    if p.get("weight") is not None:
        scale = scale * p["weight"]
        bias = p.get("bias", 0.0) - p["running_mean"] * scale
    else:
        bias = -p["running_mean"] * scale
    return x * scale.to(x.dtype) + bias.to(x.dtype)


def _prelu(p, x):
    a = p.to(x.dtype)[None, :, None, None]
    return torch.where(x >= 0, x, a * x)


def _se(p, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = torch.relu(_conv(s, p["fc1_weight"]))
    s = torch.sigmoid(_conv(s, p["fc2_weight"]))
    return x * s


def _strided_identity(x, stride):
    # MaxPool2d(1, stride): keep every stride-th pixel
    if stride == 1:
        return x
    return x[:, :, ::stride, ::stride]


def _bottleneck_ir_se(p, x, in_c, depth, stride):
    if in_c == depth:
        shortcut = _strided_identity(x, stride)
    else:
        shortcut = _bn(p["shortcut_bn"], _conv(x, p["shortcut_conv_weight"],
                                               stride=stride))
    r = _bn(p["bn1"], x)
    r = _conv(r, p["conv1_weight"], padding=1)
    r = _prelu(p["prelu"], r)
    r = _conv(r, p["conv2_weight"], stride=stride, padding=1)
    r = _bn(p["bn2"], r)
    r = _se(p["se"], r)
    return r + shortcut


def body_apply(params, x: torch.Tensor, layout: Optional[Layout] = None,
               taps: Sequence[int] = ()) -> Tuple[torch.Tensor, List]:
    """The stem and the bottlenecks: x [N, 3, S, S] → (the last bottleneck's
    output, [the output of bottleneck i for i in taps]). ArcFace reads the
    first, the e4e encoders the taps (their FPN features).

    layout: (in_channel, depth, stride) per bottleneck; IR-SE-50 when None.
    The JAX package scans uniform runs of bottlenecks (`body_runs`); here
    they are a plain loop, the same arithmetic."""
    p = params
    layout = layout if layout is not None else ir_se_50_layout()
    x = _conv(x, p["input_conv_weight"], padding=1)
    x = _bn(p["input_bn"], x)
    x = _prelu(p["input_prelu"], x)
    tapped = {}
    for i, (in_c, depth, stride) in enumerate(layout):
        x = _bottleneck_ir_se(p["body"][f"{i}"], x, in_c, depth, stride)
        if i in taps:
            tapped[i] = x
    return x, [tapped[i] for i in taps]


def backbone_apply(params, x: torch.Tensor, layout: Optional[Layout] = None
                   ) -> torch.Tensor:
    """x: [N, 3, S, S] in [-1, 1] → L2-normalized embeddings [N, 512]."""
    p = params
    x, _ = body_apply(p, x, layout)
    x = _bn(p["output_bn"], x)
    x = x.reshape(x.shape[0], -1)
    x = x @ p["output_linear"]["weight"].T.to(x.dtype) + \
        p["output_linear"]["bias"].to(x.dtype)
    x = _bn1d(p["output_bn1d"], x)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


# ----------------------------------------------------------------------- init


def _bn_init(c, dev):
    return {"weight": torch.ones((c,), device=dev),
            "bias": torch.zeros((c,), device=dev),
            "running_mean": torch.zeros((c,), device=dev),
            "running_var": torch.ones((c,), device=dev)}


def init_backbone_params(gen: torch.Generator, input_size: int = 112,
                         layout: Optional[Layout] = None,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """Random init in the JAX package's scheme (He-normal convolutions,
    identity BN, PReLU 0.25, zero SE gate weights), drawn from `gen`."""
    dev = resolve_device(device)
    layout = layout if layout is not None else ir_se_50_layout()

    def he(shape):
        fan_in = int(np.prod(shape[1:]))
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w * np.sqrt(2.0 / fan_in)).to(dev)

    stem_c = layout[0][0]
    params: Dict[str, Any] = {
        "input_conv_weight": he((stem_c, 3, 3, 3)),
        "input_bn": _bn_init(stem_c, dev),
        "input_prelu": torch.full((stem_c,), 0.25, device=dev),
        "body": {},
    }
    for i, (in_c, depth, stride) in enumerate(layout):
        bp = {
            "bn1": _bn_init(in_c, dev),
            "conv1_weight": he((depth, in_c, 3, 3)),
            "prelu": torch.full((depth,), 0.25, device=dev),
            "conv2_weight": he((depth, depth, 3, 3)),
            "bn2": _bn_init(depth, dev),
            "se": {"fc1_weight": he((max(depth // 16, 1), depth, 1, 1)),
                   "fc2_weight": torch.zeros((depth, max(depth // 16, 1), 1, 1),
                                             device=dev)},
        }
        if in_c != depth:
            bp["shortcut_conv_weight"] = he((depth, in_c, 1, 1))
            bp["shortcut_bn"] = _bn_init(depth, dev)
        params["body"][f"{i}"] = bp
    final_c = layout[-1][1]
    n_stride2 = sum(1 for (_, _, st) in layout if st == 2)
    feat = input_size // (2 ** n_stride2)
    params["output_bn"] = _bn_init(final_c, dev)
    w = torch.randn((512, final_c * feat * feat), generator=gen,
                    device=gen.device) * 0.01
    params["output_linear"] = {"weight": w.to(dev),
                               "bias": torch.zeros((512,), device=dev)}
    params["output_bn1d"] = {"running_mean": torch.zeros((512,), device=dev),
                             "running_var": torch.ones((512,), device=dev)}
    return params


# -------------------------------------------------------------- weight import


def params_from_torch_state(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Map the IR-SE-50 Backbone state_dict (model_ir_se50.pth namespace:
    input_layer.{0,1,2}, body.N.{shortcut_layer,res_layer}.M, output_layer)
    onto the params tree of numpy arrays (`convert.params_from_numpy` puts
    it on a device)."""
    t = state

    def bn(prefix):
        return {k: t[f"{prefix}.{k}"] for k in
                ("weight", "bias", "running_mean", "running_var")}

    params: Dict[str, Any] = {
        "input_conv_weight": t["input_layer.0.weight"],
        "input_bn": bn("input_layer.1"),
        "input_prelu": t["input_layer.2.weight"],
        "body": {},
    }
    for i, (in_c, depth, stride) in enumerate(ir_se_50_layout()):
        pfx = f"body.{i}"
        bp = {
            "bn1": bn(f"{pfx}.res_layer.0"),
            "conv1_weight": t[f"{pfx}.res_layer.1.weight"],
            "prelu": t[f"{pfx}.res_layer.2.weight"],
            "conv2_weight": t[f"{pfx}.res_layer.3.weight"],
            "bn2": bn(f"{pfx}.res_layer.4"),
            "se": {"fc1_weight": t[f"{pfx}.res_layer.5.fc1.weight"],
                   "fc2_weight": t[f"{pfx}.res_layer.5.fc2.weight"]},
        }
        if in_c != depth:
            bp["shortcut_conv_weight"] = t[f"{pfx}.shortcut_layer.0.weight"]
            bp["shortcut_bn"] = bn(f"{pfx}.shortcut_layer.1")
        params["body"][f"{i}"] = bp
    params["output_bn"] = bn("output_layer.0")
    params["output_linear"] = {"weight": t["output_layer.3.weight"],
                               "bias": t["output_layer.3.bias"]}
    bn1d = {"running_mean": t["output_layer.4.running_mean"],
            "running_var": t["output_layer.4.running_var"]}
    for k in ("weight", "bias"):
        if f"output_layer.4.{k}" in t:
            bn1d[k] = t[f"output_layer.4.{k}"]
    params["output_bn1d"] = bn1d
    return params
