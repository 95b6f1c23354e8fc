"""Perceptual feature backbones for LPIPS: AlexNet, VGG16 and SqueezeNet
1.1 feature stacks in functional torch (counterpart of
`stylemc_tpu/models/perceptual.py`).

torchvision `features` sequentials with fixed tap layers and per-tap
channel lists; inputs z-scored with LPIPS's shift/scale; each tap's
activation unit-normalised per pixel. Params are keyed by the torchvision
`features.N` names (`backbone_from_torch_state` maps a state dict).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

# conv specs by torchvision features index: (out_c, kernel, stride, padding);
# the other indices are ReLUs and max pools
ALEXNET_CONVS = {0: (64, 11, 4, 2), 3: (192, 5, 1, 2), 6: (384, 3, 1, 1),
                 8: (256, 3, 1, 1), 10: (256, 3, 1, 1)}
ALEXNET_POOLS = {2, 5, 12}        # MaxPool(3, stride 2) after the relu tap
ALEXNET_LEN = 13
ALEXNET_TAPS = (2, 5, 8, 10, 12)  # relu outputs, counted from 1
ALEXNET_CHANNELS = (64, 192, 384, 256, 256)

VGG16_CONVS = {0: (64, 3, 1, 1), 2: (64, 3, 1, 1), 5: (128, 3, 1, 1),
               7: (128, 3, 1, 1), 10: (256, 3, 1, 1), 12: (256, 3, 1, 1),
               14: (256, 3, 1, 1), 17: (512, 3, 1, 1), 19: (512, 3, 1, 1),
               21: (512, 3, 1, 1), 24: (512, 3, 1, 1), 26: (512, 3, 1, 1),
               28: (512, 3, 1, 1)}
VGG16_POOLS = {4, 9, 16, 23, 30}  # MaxPool(2, 2)
VGG16_LEN = 31
VGG16_TAPS = (4, 9, 16, 23, 30)
VGG16_CHANNELS = (64, 128, 256, 512, 512)

# squeezenet1_1.features: conv0 and Fire modules between ceil-mode
# MaxPool(3, 2)s; a fire: (in_c, squeeze, expand1x1, expand3x3)
SQUEEZE_CONVS = {0: (64, 3, 2, 0)}
SQUEEZE_FIRES = {3: (64, 16, 64, 64), 4: (128, 16, 64, 64),
                 6: (128, 32, 128, 128), 7: (256, 32, 128, 128),
                 9: (256, 48, 192, 192), 10: (384, 48, 192, 192),
                 11: (384, 64, 256, 256), 12: (512, 64, 256, 256)}
SQUEEZE_POOLS = {2, 5, 8}
SQUEEZE_LEN = 13
SQUEEZE_TAPS = (2, 5, 8, 10, 11, 12, 13)
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)


def _conv(x, p, stride, padding):
    return F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                    stride=stride, padding=padding)


def _maxpool(x, k, s, ceil_mode=False):
    return F.max_pool2d(x, k, s, ceil_mode=ceil_mode)


def _fire(x, p):
    """torchvision Fire: 1x1 squeeze + relu → concat(1x1 expand, 3x3
    expand), each with a relu."""
    s = F.relu(_conv(x, p["squeeze"], 1, 0))
    e1 = F.relu(_conv(s, p["expand1x1"], 1, 0))
    e3 = F.relu(_conv(s, p["expand3x3"], 1, 1))
    return torch.cat([e1, e3], dim=1)


def normalize_activation(x, eps=1e-10):
    norm = torch.sqrt(torch.sum(x.square(), dim=1, keepdim=True))
    return x / (norm + eps)


def _z_score(x):
    mean = torch.tensor(LPIPS_SHIFT, dtype=x.dtype,
                        device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(LPIPS_SCALE, dtype=x.dtype,
                       device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def _net_spec(net_type: str):
    """→ (convs, fires, pools, length, taps, channels, pool (k, s),
    ceil_mode)."""
    if net_type == "alex":
        return ALEXNET_CONVS, {}, ALEXNET_POOLS, ALEXNET_LEN, ALEXNET_TAPS, \
            ALEXNET_CHANNELS, (3, 2), False
    if net_type == "vgg":
        return VGG16_CONVS, {}, VGG16_POOLS, VGG16_LEN, VGG16_TAPS, \
            VGG16_CHANNELS, (2, 2), False
    if net_type == "squeeze":
        return SQUEEZE_CONVS, SQUEEZE_FIRES, SQUEEZE_POOLS, SQUEEZE_LEN, \
            SQUEEZE_TAPS, SQUEEZE_CHANNELS, (3, 2), True
    raise NotImplementedError(f"net_type {net_type!r} (alex|vgg|squeeze)")


def features(params, x, net_type: str = "alex") -> List[torch.Tensor]:
    """x: [N, 3, H, W] in [-1, 1] → the unit-normalised tap activations.
    Layers are counted from 1 and a tap is taken after its layer."""
    convs, fires, pools, length, taps, _, pool_ks, ceil = _net_spec(net_type)
    x = _z_score(x)
    out = []
    for idx in range(length):
        if idx in convs:
            c, k, s, pad = convs[idx]
            x = _conv(x, params[f"features.{idx}"], s, pad)
        elif idx in fires:
            x = _fire(x, params[f"features.{idx}"])
        elif idx in pools:
            x = _maxpool(x, pool_ks[0], pool_ks[1], ceil)
        else:  # ReLU
            x = F.relu(x)
        if (idx + 1) in taps:
            out.append(normalize_activation(x))
        if len(out) == len(taps):
            break
    return out


def lpips_channels(net_type: str = "alex") -> Sequence[int]:
    return _net_spec(net_type)[5]


def init_backbone(gen: torch.Generator, net_type: str = "alex",
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded He-normal convs with zero biases, drawn from `gen`."""
    dev = resolve_device(device)
    convs, fires, *_ = _net_spec(net_type)
    params = {}
    in_c = 3

    def he(shape):
        fan = shape[1] * shape[2] * shape[3]
        w = torch.randn(shape, generator=gen, device=gen.device) * \
            float(np.sqrt(2.0 / fan))
        return {"weight": w.to(dev), "bias": torch.zeros(shape[0], device=dev)}

    for idx in sorted({**convs, **fires}):
        if idx in convs:
            c, k, s, pad = convs[idx]
            params[f"features.{idx}"] = he((c, in_c, k, k))
            in_c = c
        else:
            fin, sq, e1, e3 = fires[idx]
            params[f"features.{idx}"] = {
                "squeeze": he((sq, fin, 1, 1)),
                "expand1x1": he((e1, sq, 1, 1)),
                "expand3x3": he((e3, sq, 3, 3)),
            }
            in_c = e1 + e3
    return params


def backbone_from_torch_state(state: Dict[str, np.ndarray],
                              net_type: str = "alex") -> Dict[str, Any]:
    """torchvision `features.*` state (numpy values) → the params tree of
    numpy arrays."""
    convs, fires, *_ = _net_spec(net_type)
    params = {}
    for idx in sorted(convs):
        params[f"features.{idx}"] = {
            "weight": state[f"features.{idx}.weight"],
            "bias": state[f"features.{idx}.bias"],
        }
    for idx in sorted(fires):
        params[f"features.{idx}"] = {
            part: {"weight": state[f"features.{idx}.{part}.weight"],
                   "bias": state[f"features.{idx}.{part}.bias"]}
            for part in ("squeeze", "expand1x1", "expand3x3")
        }
    return params
