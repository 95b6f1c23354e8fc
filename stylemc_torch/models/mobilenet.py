"""MobileNetV2 with the global-depthwise-conv landmark head (counterpart of
`stylemc_tpu/models/mobilenet.py`): torchvision's mobilenet_v2 features
(inverted residuals, ReLU6), then a linear 7x7 depthwise ConvBlock and a
linear 1x1 ConvBlock to 136 outputs (68 landmarks · 2). A 224² input leaves
a 7² map.

Functions over a params dict with the JAX package's layout, eval-mode
BatchNorm. `params_from_torch_state` reads the reference checkpoint's
namespace (mobilenet_224_model_best_gdconv_external.pth.tar, saved from a
DataParallel wrapper: a 'module.' prefix, 'base_net.0.*' or
'pretrain_net.features.*' for the features); `params_to_torch_state`
writes it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

# torchvision MobileNetV2 inverted-residual settings: (t, c, n, s)
MOBILENET_V2_SETTINGS = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _bn(p, x, eps=1e-5):
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    bias = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None] + bias[None, :, None, None]


def _conv_bn_relu(p, x, stride, groups=1, k=3):
    x = F.conv2d(x, p["conv"], stride=stride, padding=(k - 1) // 2,
                 groups=groups)
    return torch.clamp(_bn(p["bn"], x), 0.0, 6.0)


def _inverted_residual(p, x, t, stride):
    h = x
    if t != 1:
        h = _conv_bn_relu(p["expand"], h, 1, k=1)
    h = _conv_bn_relu(p["dw"], h, stride, groups=h.shape[1], k=3)
    h = _bn(p["project_bn"], F.conv2d(h, p["project_conv"]))
    if stride == 1 and x.shape[1] == h.shape[1]:
        return x + h
    return h


def _block_layout() -> List[Tuple[int, int]]:
    """(expand_ratio, stride) of each inverted-residual block in order."""
    return [(t, s if i == 0 else 1)
            for t, c, n, s in MOBILENET_V2_SETTINGS for i in range(n)]


def mobilenet_gdconv_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: [N, 3, 224, 224] ImageNet-normalised → landmarks [N, 136]."""
    x = _conv_bn_relu(params["stem"], x, 2, k=3)
    for i, (t, s) in enumerate(_block_layout()):
        x = _inverted_residual(params["blocks"][f"{i}"], x, t, s)
    x = _conv_bn_relu(params["head"], x, 1, k=1)
    # linear7: depthwise KxK over the whole map (K = 7 at 224), BN, linear
    x = _bn(params["linear7"]["bn"],
            F.conv2d(x, params["linear7"]["conv"], groups=x.shape[1]))
    x = _bn(params["linear1"]["bn"], F.conv2d(x, params["linear1"]["conv"]))
    return x.reshape(x.shape[0], -1)


# ----------------------------------------------------------------------- init


def init_mobilenet_gdconv_params(gen: torch.Generator,
                                 num_classes: int = 136, gd_kernel: int = 7,
                                 device: DeviceLike = None) -> Dict[str, Any]:
    """Random init in the JAX package's scheme (He-normal convolutions,
    identity BN), drawn from `gen`."""
    dev = resolve_device(device)

    def he(shape):
        fan = int(np.prod(shape[1:]))
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w * np.sqrt(2.0 / max(fan, 1))).to(dev)

    def bn(c):
        return {"weight": torch.ones((c,), device=dev),
                "bias": torch.zeros((c,), device=dev),
                "running_mean": torch.zeros((c,), device=dev),
                "running_var": torch.ones((c,), device=dev)}

    params: Dict[str, Any] = {
        "stem": {"conv": he((32, 3, 3, 3)), "bn": bn(32)}, "blocks": {}}
    cin, i = 32, 0
    for t, c, n, _ in MOBILENET_V2_SETTINGS:
        for _ in range(n):
            hidden = cin * t
            bp: Dict[str, Any] = {}
            if t != 1:
                bp["expand"] = {"conv": he((hidden, cin, 1, 1)),
                                "bn": bn(hidden)}
            bp["dw"] = {"conv": he((hidden, 1, 3, 3)), "bn": bn(hidden)}
            bp["project_conv"] = he((c, hidden, 1, 1))
            bp["project_bn"] = bn(c)
            params["blocks"][f"{i}"] = bp
            cin, i = c, i + 1
    params["head"] = {"conv": he((1280, 320, 1, 1)), "bn": bn(1280)}
    params["linear7"] = {"conv": he((1280, 1, gd_kernel, gd_kernel)),
                         "bn": bn(1280)}
    params["linear1"] = {"conv": he((num_classes, 1280, 1, 1)),
                         "bn": bn(num_classes)}
    return params


# ------------------------------------------------------------- torch state


def _feature_names(i: int, t: int) -> Dict[str, str]:
    """Our block keys → the torchvision features.{i+1} names."""
    fi = i + 1
    if t != 1:
        return {"expand.conv": f"{fi}.conv.0.0.weight",
                "expand.bn": f"{fi}.conv.0.1",
                "dw.conv": f"{fi}.conv.1.0.weight", "dw.bn": f"{fi}.conv.1.1",
                "project_conv": f"{fi}.conv.2.weight",
                "project_bn": f"{fi}.conv.3"}
    return {"dw.conv": f"{fi}.conv.0.0.weight", "dw.bn": f"{fi}.conv.0.1",
            "project_conv": f"{fi}.conv.1.weight",
            "project_bn": f"{fi}.conv.2"}


def params_from_torch_state(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference checkpoint's state_dict → the params tree of numpy
    arrays (`convert.params_from_numpy` puts it on a device)."""
    t = {(k[len("module."):] if k.startswith("module.") else k): v
         for k, v in state.items()}

    def feat(name):
        for root in ("base_net.0", "pretrain_net.features"):
            if f"{root}.{name}" in t:
                return t[f"{root}.{name}"]
        raise KeyError(name)

    def bn(prefix, get=feat):
        return {k: get(f"{prefix}.{k}") for k in _BN_KEYS}

    params: Dict[str, Any] = {
        "stem": {"conv": feat("0.0.weight"), "bn": bn("0.1")}, "blocks": {}}
    for i, (t_ratio, _) in enumerate(_block_layout()):
        names = _feature_names(i, t_ratio)
        bp: Dict[str, Any] = {}
        if t_ratio != 1:
            bp["expand"] = {"conv": feat(names["expand.conv"]),
                            "bn": bn(names["expand.bn"])}
        bp["dw"] = {"conv": feat(names["dw.conv"]), "bn": bn(names["dw.bn"])}
        bp["project_conv"] = feat(names["project_conv"])
        bp["project_bn"] = bn(names["project_bn"])
        params["blocks"][f"{i}"] = bp
    params["head"] = {"conv": feat("18.0.weight"), "bn": bn("18.1")}
    for head in ("linear7", "linear1"):
        params[head] = {"conv": t[f"{head}.conv.weight"],
                        "bn": bn(f"{head}.bn", get=t.__getitem__)}
    return params


def params_to_torch_state(params) -> Dict[str, torch.Tensor]:
    """The params tree → the reference checkpoint's state_dict namespace
    ('module.base_net.0.*', 'module.linear7.*', 'module.linear1.*'), CPU
    float32 tensors; `params_from_torch_state` reads it back."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, v):
        out[f"module.{name}"] = torch.as_tensor(v).detach().float().cpu()

    def put_bn(prefix, p):
        for k in _BN_KEYS:
            put(f"{prefix}.{k}", p[k])

    base = "base_net.0"
    put(f"{base}.0.0.weight", params["stem"]["conv"])
    put_bn(f"{base}.0.1", params["stem"]["bn"])
    for i, (t_ratio, _) in enumerate(_block_layout()):
        bp, names = params["blocks"][f"{i}"], _feature_names(i, t_ratio)
        if t_ratio != 1:
            put(f"{base}.{names['expand.conv']}", bp["expand"]["conv"])
            put_bn(f"{base}.{names['expand.bn']}", bp["expand"]["bn"])
        put(f"{base}.{names['dw.conv']}", bp["dw"]["conv"])
        put_bn(f"{base}.{names['dw.bn']}", bp["dw"]["bn"])
        put(f"{base}.{names['project_conv']}", bp["project_conv"])
        put_bn(f"{base}.{names['project_bn']}", bp["project_bn"])
    put(f"{base}.18.0.weight", params["head"]["conv"])
    put_bn(f"{base}.18.1", params["head"]["bn"])
    for head in ("linear7", "linear1"):
        put(f"{head}.conv.weight", params[head]["conv"])
        put_bn(f"{head}.bn", params[head]["bn"])
    return out
