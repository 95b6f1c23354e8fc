"""MTCNN P/R/O networks (counterpart of `stylemc_tpu/models/mtcnn/nets.py`):
three small conv/PReLU cascades over a params dict keyed by the reference's
torch parameter names. The flatten transposes H and W before reshaping
(the original Caffe weight layout); max pooling is ceil-mode. Weights load
from the reference's {p,r,o}net.npy dicts.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...device import DeviceLike, resolve_device


def _conv(p, name, x):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _prelu(p, name, x):
    a = p[f"{name}.weight"]
    if x.ndim == 4:
        a = a[None, :, None, None]
    return torch.where(x >= 0, x, a * x)


def _maxpool_ceil(x, k, s):
    """MaxPool2d(k, s, ceil_mode=True): the high edges padded with -inf so
    the ceil division holds."""
    h, w = x.shape[2], x.shape[3]
    out_h = -(-max(h - k, 0) // s) + 1
    out_w = -(-max(w - k, 0) // s) + 1
    pad_h = max((out_h - 1) * s + k - h, 0)
    pad_w = max((out_w - 1) * s + k - w, 0)
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=-math.inf)
    return F.max_pool2d(x, k, s)


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _flatten_caffe(x):
    return x.transpose(2, 3).reshape(x.shape[0], -1)


def _features(p, x, pools):
    """conv{i} → prelu{i} → (pool) for each entry of `pools` (k, s or
    None)."""
    for i, pool in enumerate(pools, start=1):
        x = _prelu(p, f"features.prelu{i}", _conv(p, f"features.conv{i}", x))
        if pool is not None:
            x = _maxpool_ceil(x, *pool)
    return x


def pnet_apply(p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, 3, H, W] → (offsets [N, 4, h, w], probs [N, 2, h, w])."""
    x = _features(p, x, [(2, 2), None, None])
    a = _conv(p, "conv4_1", x)
    b = _conv(p, "conv4_2", x)
    return b, torch.softmax(a, dim=1)


def rnet_apply(p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, 3, 24, 24] → (offsets [N, 4], probs [N, 2])."""
    x = _flatten_caffe(_features(p, x, [(3, 2), (3, 2), None]))
    x = _prelu(p, "features.prelu4", _linear(p, "features.conv4", x))
    a = _linear(p, "conv5_1", x)
    b = _linear(p, "conv5_2", x)
    return b, torch.softmax(a, dim=1)


def onet_apply(p, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N, 3, 48, 48] → (landmarks [N, 10], offsets [N, 4], probs
    [N, 2])."""
    x = _flatten_caffe(_features(p, x, [(3, 2), (3, 2), (2, 2), None]))
    x = _prelu(p, "features.prelu5", _linear(p, "features.conv5", x))
    a = _linear(p, "conv6_1", x)
    b = _linear(p, "conv6_2", x)
    c = _linear(p, "conv6_3", x)
    return c, b, torch.softmax(a, dim=1)


def load_net_weights(path: str, device: DeviceLike = None
                     ) -> Dict[str, torch.Tensor]:
    """A {p,r,o}net.npy dict (torch-named arrays) → float32 tensors on
    `device`."""
    dev = resolve_device(device)
    weights = np.load(path, allow_pickle=True)[()]
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in weights.items()}


def save_net_weights(path: str, params) -> None:
    """Write `params` as the reference's .npy dict of float32 arrays
    (`load_net_weights` reads it)."""
    np.save(path, {k: torch.as_tensor(v).detach().cpu().numpy()
                   .astype(np.float32) for k, v in params.items()},
            allow_pickle=True)


# the nets' shapes, for random init when the weight files are absent
_SHAPES = {
    "pnet": {"features.conv1": (10, 3, 3, 3),
             "features.conv2": (16, 10, 3, 3),
             "features.conv3": (32, 16, 3, 3), "conv4_1": (2, 32, 1, 1),
             "conv4_2": (4, 32, 1, 1)},
    "rnet": {"features.conv1": (28, 3, 3, 3),
             "features.conv2": (48, 28, 3, 3),
             "features.conv3": (64, 48, 2, 2), "features.conv4": (128, 576),
             "conv5_1": (2, 128), "conv5_2": (4, 128)},
    "onet": {"features.conv1": (32, 3, 3, 3),
             "features.conv2": (64, 32, 3, 3),
             "features.conv3": (64, 64, 3, 3),
             "features.conv4": (128, 64, 2, 2),
             "features.conv5": (256, 1152), "conv6_1": (2, 256),
             "conv6_2": (4, 256), "conv6_3": (10, 256)},
}
_PRELU_CHANNELS = {"pnet": (10, 16, 32), "rnet": (28, 48, 64, 128),
                   "onet": (32, 64, 64, 128, 256)}


def init_net_params(gen: torch.Generator, which: str,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random init in the JAX package's scheme: weights N(0, 1/fan_in),
    zero biases, PReLU slopes 0.25; drawn from `gen`."""
    dev = resolve_device(device)
    params = {}
    for name, shape in _SHAPES[which].items():
        fan = int(np.prod(shape[1:]))
        w = torch.randn(shape, generator=gen, device=gen.device)
        params[f"{name}.weight"] = (w / np.sqrt(fan)).to(dev)
        params[f"{name}.bias"] = torch.zeros((shape[0],), device=dev)
    for i, c in enumerate(_PRELU_CHANNELS[which], start=1):
        params[f"features.prelu{i}.weight"] = torch.full((c,), 0.25,
                                                         device=dev)
    return params
