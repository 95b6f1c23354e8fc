"""StyleGAN2 image discriminator (counterpart of
`stylemc_tpu/models/stylegan2/discriminator.py`).

The rosinality resnet `Discriminator`: a 1x1 conv stem, residual
down-blocks (two 3x3 convs with fused lrelu, a blur-downsampled 1x1 skip,
the sum scaled by 1/√2), the minibatch-stddev feature, a final conv and a
two-layer equalized-lr linear head. The blur-downsample goes through the
plain `conv2d_resample(down=2)`, as the JAX package computes it outside any
Pallas kernel. Weight import maps the rosinality `d` state dict and the
NVIDIA ADA `Discriminator` namespace (TF pickles convert onto the former,
`io/tf_legacy.py`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...ops import conv2d_resample, setup_filter_np


def d_channels(size: int, channel_multiplier: int = 2) -> Dict[int, int]:
    return {res: min(int(2 ** 14 * channel_multiplier / res), 512)
            if res >= 64 else 512
            for res in [2 ** i for i in range(2, int(np.log2(size)) + 1)]}


def _equal_conv(x, w, padding=0, f=None, down=1):
    """EqualConv2d: the runtime scale 1/sqrt(fan_in)."""
    _, in_c, kh, kw = w.shape
    scale = 1.0 / np.sqrt(in_c * kh * kw)
    if down > 1:
        return conv2d_resample(x, w * scale, f=f, down=down, padding=padding)
    return conv2d_resample(x, w * scale, padding=padding)


def _flrelu(x, bias):
    x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2)).to(x.dtype)
    return torch.where(x >= 0, x, 0.2 * x) * float(np.sqrt(2))


def _equal_linear(p, x, lr_mul=1.0, act=False):
    w = p["weight"]
    scale = (1.0 / np.sqrt(w.shape[1])) * lr_mul
    y = x @ (w * scale).T.to(x.dtype)
    if act:
        return _flrelu(y, p["bias"] * lr_mul)
    return y + (p["bias"] * lr_mul).to(x.dtype)


def minibatch_stddev(x, group_size: int = 4):
    """The per-group feature stddev, appended as one channel."""
    n, c, h, w = x.shape
    g = min(n, group_size)
    while n % g != 0:
        g -= 1
    y = x.reshape(g, n // g, 1, c, h, w)
    var = torch.var(y, dim=0, unbiased=False)
    stddev = torch.sqrt(var + 1e-8)
    stddev = stddev.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
    stddev = stddev.repeat(g, 1, h, w)
    return torch.cat([x, stddev], dim=1)


def discriminator_apply(params, x, blur_kernel=(1, 3, 3, 1)):
    """x: [N, 3, S, S] in [-1, 1] → logits [N, 1]."""
    f = setup_filter_np(blur_kernel)
    log_size = int(np.log2(x.shape[-1]))

    h = _flrelu(_equal_conv(x, params["stem"]["weight"]),
                params["stem"]["bias"])
    for i in range(log_size, 2, -1):
        bp = params[f"block{2 ** i}"]
        skip = _equal_conv(h, bp["skip_weight"], f=f, down=2)
        h = _flrelu(_equal_conv(h, bp["conv1"]["weight"], padding=1),
                    bp["conv1"]["bias"])
        h = _flrelu(_equal_conv(h, bp["conv2"]["weight"], padding=1, f=f,
                                down=2), bp["conv2"]["bias"])
        h = (h + skip) / float(np.sqrt(2))

    h = minibatch_stddev(h)
    h = _flrelu(_equal_conv(h, params["final_conv"]["weight"], padding=1),
                params["final_conv"]["bias"])
    h = h.reshape(h.shape[0], -1)
    h = _equal_linear(params["final_linear1"], h, act=True)
    return _equal_linear(params["final_linear2"], h)


def init_discriminator_params(generator: torch.Generator, size: int = 256,
                              channel_multiplier: int = 2,
                              device: DeviceLike = None) -> Dict[str, Any]:
    """Standard-normal weights and zero biases, drawn on the CPU from
    `generator` (the same draw on every device) in a fixed order."""
    ch = d_channels(size, channel_multiplier)
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator).to(dev)

    def conv_init(cin, cout, k):
        return {"weight": normal(cout, cin, k, k),
                "bias": torch.zeros((cout,), device=dev)}

    log_size = int(np.log2(size))
    params: Dict[str, Any] = {"stem": conv_init(3, ch[size], 1)}
    in_c = ch[size]
    for i in range(log_size, 2, -1):
        out_c = ch[2 ** (i - 1)]
        params[f"block{2 ** i}"] = {
            "conv1": conv_init(in_c, in_c, 3),
            "conv2": conv_init(in_c, out_c, 3),
            "skip_weight": normal(out_c, in_c, 1, 1),
        }
        in_c = out_c
    params["final_conv"] = conv_init(in_c + 1, ch[4], 3)
    params["final_linear1"] = {"weight": normal(ch[4], ch[4] * 16),
                               "bias": torch.zeros((ch[4],), device=dev)}
    params["final_linear2"] = {"weight": normal(1, ch[4]),
                               "bias": torch.zeros((1,), device=dev)}
    return params


def _tensors(state, device: DeviceLike):
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in state.items()}


def d_params_from_ada(state: Dict[str, np.ndarray], size: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """NVIDIA ADA Discriminator state dict → params: `b{res}.fromrgb` (the
    stem, top resolution only), per block `b{res}.conv0` (same resolution),
    `conv1` (down) and `skip`, then `b4.conv`, `b4.fc` and `b4.out`."""
    t = _tensors(state, device)
    params: Dict[str, Any] = {
        "stem": {"weight": t[f"b{size}.fromrgb.weight"],
                 "bias": t[f"b{size}.fromrgb.bias"]},
    }
    for i in range(int(np.log2(size)), 2, -1):
        r = 2 ** i
        params[f"block{r}"] = {
            "conv1": {"weight": t[f"b{r}.conv0.weight"],
                      "bias": t[f"b{r}.conv0.bias"]},
            "conv2": {"weight": t[f"b{r}.conv1.weight"],
                      "bias": t[f"b{r}.conv1.bias"]},
            "skip_weight": t[f"b{r}.skip.weight"],
        }
    params["final_conv"] = {"weight": t["b4.conv.weight"],
                            "bias": t["b4.conv.bias"]}
    params["final_linear1"] = {"weight": t["b4.fc.weight"],
                               "bias": t["b4.fc.bias"]}
    params["final_linear2"] = {"weight": t["b4.out.weight"],
                               "bias": t["b4.out.bias"]}
    return params


def d_params_from_rosinality(state: Dict[str, np.ndarray], size: int,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """rosinality Discriminator state dict → params: convs.0 the stem,
    convs.1..N the residual blocks, final_conv, final_linear.{0,1}."""
    t = _tensors(state, device)
    params: Dict[str, Any] = {
        "stem": {"weight": t["convs.0.0.weight"],
                 "bias": t["convs.0.1.bias"]},
    }
    for idx, i in enumerate(range(int(np.log2(size)), 2, -1), start=1):
        pfx = f"convs.{idx}"
        params[f"block{2 ** i}"] = {
            "conv1": {"weight": t[f"{pfx}.conv1.0.weight"],
                      "bias": t[f"{pfx}.conv1.1.bias"]},
            "conv2": {"weight": t[f"{pfx}.conv2.1.weight"],
                      "bias": t[f"{pfx}.conv2.2.bias"]},
            "skip_weight": t[f"{pfx}.skip.1.weight"],
        }
    params["final_conv"] = {"weight": t["final_conv.0.weight"],
                            "bias": t["final_conv.1.bias"]}
    params["final_linear1"] = {"weight": t["final_linear.0.weight"],
                               "bias": t["final_linear.0.bias"]}
    params["final_linear2"] = {"weight": t["final_linear.1.weight"],
                               "bias": t["final_linear.1.bias"]}
    return params
