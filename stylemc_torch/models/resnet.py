"""torchvision ResNet-50 in functional torch (counterpart of
`stylemc_tpu/models/resnet.py`): MoCo-v2's feature backbone, the final fc
removed, the globally average-pooled features out. Batch norm in eval mode
(running statistics)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

RESNET50_LAYERS = (3, 4, 6, 3)


def _conv(x, w, stride=1, padding=0):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(p, x, eps=1e-5):
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    bias = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None].to(x.dtype) + \
        bias[None, :, None, None].to(x.dtype)


def _bottleneck(p, x, stride=1):
    out = torch.relu(_bn(p["bn1"], _conv(x, p["conv1_weight"])))
    out = torch.relu(_bn(p["bn2"], _conv(out, p["conv2_weight"],
                                         stride=stride, padding=1)))
    out = _bn(p["bn3"], _conv(out, p["conv3_weight"]))
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["1"],
                       _conv(x, p["downsample"]["0_weight"], stride=stride))
    return torch.relu(out + identity)


def resnet50_features(params, x: torch.Tensor) -> torch.Tensor:
    """x: [N,3,224,224] → pooled features [N, 2048]."""
    x = _conv(x, params["conv1_weight"], stride=2, padding=3)
    x = torch.relu(_bn(params["bn1"], x))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for li, depth in enumerate(RESNET50_LAYERS):
        layer = params[f"layer{li + 1}"]
        stride = 1 if li == 0 else 2
        for bi in range(depth):
            x = _bottleneck(layer[f"{bi}"], x, stride=stride if bi == 0 else 1)
    return x.mean(dim=(2, 3))


def _bn_init(c, dev):
    return {"weight": torch.ones((c,), device=dev),
            "bias": torch.zeros((c,), device=dev),
            "running_mean": torch.zeros((c,), device=dev),
            "running_var": torch.ones((c,), device=dev)}


def init_resnet50_params(gen: torch.Generator, device: DeviceLike = None
                         ) -> Dict[str, Any]:
    """He-normal convolutions and identity batch norms, drawn from `gen`."""
    dev = resolve_device(device)

    def he(shape):
        fan = int(np.prod(shape[1:]))
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w * float(np.sqrt(2.0 / fan))).to(dev)

    params: Dict[str, Any] = {"conv1_weight": he((64, 3, 7, 7)),
                              "bn1": _bn_init(64, dev)}
    cin = 64
    for li, depth in enumerate(RESNET50_LAYERS):
        cmid = 64 * (2 ** li)
        layer = {}
        for bi in range(depth):
            bp = {"conv1_weight": he((cmid, cin, 1, 1)),
                  "bn1": _bn_init(cmid, dev),
                  "conv2_weight": he((cmid, cmid, 3, 3)),
                  "bn2": _bn_init(cmid, dev),
                  "conv3_weight": he((cmid * 4, cmid, 1, 1)),
                  "bn3": _bn_init(cmid * 4, dev)}
            if bi == 0:
                bp["downsample"] = {"0_weight": he((cmid * 4, cin, 1, 1)),
                                    "1": _bn_init(cmid * 4, dev)}
            layer[f"{bi}"] = bp
            cin = cmid * 4
        params[f"layer{li + 1}"] = layer
    return params


def resnet50_from_torch_state(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """torchvision resnet50 names (MoCo's `module.encoder_q.` prefix
    already stripped) → the params tree of numpy arrays
    (`convert.params_from_numpy` puts it on a device)."""
    def bn(prefix):
        return {k: state[f"{prefix}.{k}"] for k in
                ("weight", "bias", "running_mean", "running_var")}

    params: Dict[str, Any] = {"conv1_weight": state["conv1.weight"],
                              "bn1": bn("bn1")}
    for li, depth in enumerate(RESNET50_LAYERS):
        layer = {}
        for bi in range(depth):
            pfx = f"layer{li + 1}.{bi}"
            bp = {}
            for ci in (1, 2, 3):
                bp[f"conv{ci}_weight"] = state[f"{pfx}.conv{ci}.weight"]
                bp[f"bn{ci}"] = bn(f"{pfx}.bn{ci}")
            if f"{pfx}.downsample.0.weight" in state:
                bp["downsample"] = {
                    "0_weight": state[f"{pfx}.downsample.0.weight"],
                    "1": bn(f"{pfx}.downsample.1")}
            layer[f"{bi}"] = bp
        params[f"layer{li + 1}"] = layer
    return params
