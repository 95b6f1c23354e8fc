"""Inception v3 feature extractor in functional torch, the FID/KID/IS
detector (counterpart of `stylemc_tpu/metrics/inception.py`).

Two variants share the graph code:

  variant="fid2015" (default, the reference's detector): the Inception-2015
    TF graph as the pytorch-fid port encodes it: 1008-way logits, the A/C
    blocks and Mixed_7b average-pool with count_include_pad=False, and
    Mixed_7c's pool branch is a max pool. FIDs are comparable to published
    ones given the Inception-2015 weights.
  variant="tv": torchvision's inception_v3 graph (1000-way fc,
    count_include_pad average pools). Not comparable to reference FIDs.

BasicConv2d = conv + BN (eps 1e-3, running statistics) + ReLU; 2048-d
pool3 features; fc logits. Input: uint8 [N, H, W, 3] (a numpy array or a
tensor), resized to 299² by the same bilinear matrices as the JAX package
and scaled to [-1, 1]. Weights: `init_inception_params` (seeded, the JAX
initialiser's scales) or `params_from_torch_state` (torchvision names).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device


def _conv(x, w, stride=1, padding=0):
    """padding: an int, or [(top, bottom), (left, right)] (symmetric)."""
    if not isinstance(padding, int):
        padding = (padding[0][0], padding[1][0])
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(p, x, eps=1e-3):
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    bias = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None].to(x.dtype) + \
        bias[None, :, None, None].to(x.dtype)


def _basic(p, x, stride=1, padding=0):
    return F.relu(_bn(p["bn"], _conv(x, p["conv_weight"], stride, padding)))


def _maxpool(x, k=3, s=2):
    return F.max_pool2d(x, k, s)


def _avgpool3(x, count_include_pad: bool = True):
    # count_include_pad=False divides by the valid taps of each window: TF
    # 'SAME' average pooling, the Inception-2015 quirk
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def _maxpool3s1(x):
    return F.max_pool2d(x, 3, 1, 1)


def _inception_a(p, x, fid: bool = False):
    b1 = _basic(p["branch1x1"], x)
    b5 = _basic(p["branch5x5_1"], x)
    b5 = _basic(p["branch5x5_2"], b5, padding=2)
    b3 = _basic(p["branch3x3dbl_1"], x)
    b3 = _basic(p["branch3x3dbl_2"], b3, padding=1)
    b3 = _basic(p["branch3x3dbl_3"], b3, padding=1)
    bp = _basic(p["branch_pool"], _avgpool3(x, count_include_pad=not fid))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, x, fid: bool = False):
    del fid  # no pooling-variant difference in reduction block B
    b3 = _basic(p["branch3x3"], x, stride=2)
    bd = _basic(p["branch3x3dbl_1"], x)
    bd = _basic(p["branch3x3dbl_2"], bd, padding=1)
    bd = _basic(p["branch3x3dbl_3"], bd, stride=2)
    bp = _maxpool(x)
    return torch.cat([b3, bd, bp], dim=1)


def _inception_c(p, x, fid: bool = False):
    b1 = _basic(p["branch1x1"], x)
    b7 = _basic(p["branch7x7_1"], x)
    b7 = _basic(p["branch7x7_2"], b7, padding=[(0, 0), (3, 3)])
    b7 = _basic(p["branch7x7_3"], b7, padding=[(3, 3), (0, 0)])
    bd = _basic(p["branch7x7dbl_1"], x)
    bd = _basic(p["branch7x7dbl_2"], bd, padding=[(3, 3), (0, 0)])
    bd = _basic(p["branch7x7dbl_3"], bd, padding=[(0, 0), (3, 3)])
    bd = _basic(p["branch7x7dbl_4"], bd, padding=[(3, 3), (0, 0)])
    bd = _basic(p["branch7x7dbl_5"], bd, padding=[(0, 0), (3, 3)])
    bp = _basic(p["branch_pool"], _avgpool3(x, count_include_pad=not fid))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, x, fid: bool = False):
    del fid  # no pooling-variant difference in reduction block D
    b3 = _basic(p["branch3x3_1"], x)
    b3 = _basic(p["branch3x3_2"], b3, stride=2)
    b7 = _basic(p["branch7x7x3_1"], x)
    b7 = _basic(p["branch7x7x3_2"], b7, padding=[(0, 0), (3, 3)])
    b7 = _basic(p["branch7x7x3_3"], b7, padding=[(3, 3), (0, 0)])
    b7 = _basic(p["branch7x7x3_4"], b7, stride=2)
    bp = _maxpool(x)
    return torch.cat([b3, b7, bp], dim=1)


def _inception_e(p, x, fid: bool = False, last: bool = False):
    b1 = _basic(p["branch1x1"], x)
    b3 = _basic(p["branch3x3_1"], x)
    b3a = _basic(p["branch3x3_2a"], b3, padding=[(0, 0), (1, 1)])
    b3b = _basic(p["branch3x3_2b"], b3, padding=[(1, 1), (0, 0)])
    b3 = torch.cat([b3a, b3b], dim=1)
    bd = _basic(p["branch3x3dbl_1"], x)
    bd = _basic(p["branch3x3dbl_2"], bd, padding=1)
    bda = _basic(p["branch3x3dbl_3a"], bd, padding=[(0, 0), (1, 1)])
    bdb = _basic(p["branch3x3dbl_3b"], bd, padding=[(1, 1), (0, 0)])
    bd = torch.cat([bda, bdb], dim=1)
    if fid and last:
        # Inception-2015's Mixed_7c pool branch is a max pool
        pool = _maxpool3s1(x)
    else:
        pool = _avgpool3(x, count_include_pad=not fid)
    bp = _basic(p["branch_pool"], pool)
    return torch.cat([b1, b3, bd, bp], dim=1)


def _inception_e_last(p, x, fid: bool = False):
    return _inception_e(p, x, fid=fid, last=True)


_BLOCKS = [
    ("Mixed_5b", _inception_a), ("Mixed_5c", _inception_a),
    ("Mixed_5d", _inception_a), ("Mixed_6a", _inception_b),
    ("Mixed_6b", _inception_c), ("Mixed_6c", _inception_c),
    ("Mixed_6d", _inception_c), ("Mixed_6e", _inception_c),
    ("Mixed_7a", _inception_d), ("Mixed_7b", _inception_e),
    ("Mixed_7c", _inception_e_last),
]

VARIANTS = ("fid2015", "tv")


def inception_features(params, images_u8, return_logits: bool = False,
                       variant: str = "fid2015"):
    """images_u8: uint8/float [N, H, W, 3] → pool features [N, 2048] (or
    softmax probabilities [N, num_classes] with return_logits), on the
    params' device."""
    assert variant in VARIANTS, f"unknown detector variant {variant!r}"
    fid = variant == "fid2015"
    dev = params["fc"]["weight"].device
    x = torch.as_tensor(images_u8, device=dev).float().permute(0, 3, 1, 2)
    if x.shape[-1] != 299:
        # the torchvision FID convention: bilinear resize to 299
        ky = torch.from_numpy(_resize_matrix_bilinear(x.shape[-2], 299)).to(dev)
        kx = torch.from_numpy(_resize_matrix_bilinear(x.shape[-1], 299)).to(dev)
        x = torch.einsum("oh,nchw->ncow", ky, x)
        x = torch.einsum("ow,nchw->ncho", kx, x)
    x = x / 127.5 - 1.0

    p = params
    x = _basic(p["Conv2d_1a_3x3"], x, stride=2)
    x = _basic(p["Conv2d_2a_3x3"], x)
    x = _basic(p["Conv2d_2b_3x3"], x, padding=1)
    x = _maxpool(x)
    x = _basic(p["Conv2d_3b_1x1"], x)
    x = _basic(p["Conv2d_4a_3x3"], x)
    x = _maxpool(x)
    for name, fn in _BLOCKS:
        x = fn(p[name], x, fid=fid)
    feats = x.mean(dim=(2, 3))
    if return_logits:
        logits = feats @ p["fc"]["weight"].T.to(feats.dtype) + \
            p["fc"]["bias"].to(feats.dtype)
        return torch.softmax(logits, dim=-1)
    return feats


@functools.lru_cache(maxsize=16)
def _resize_matrix_bilinear(in_size: int, out_size: int) -> np.ndarray:
    """align_corners=False bilinear resize matrix [out_size, in_size]."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        pos = (i + 0.5) * scale - 0.5
        lo = int(np.floor(pos))
        frac = pos - lo
        lo_c = min(max(lo, 0), in_size - 1)
        hi_c = min(max(lo + 1, 0), in_size - 1)
        mat[i, lo_c] += 1 - frac
        mat[i, hi_c] += frac
    return mat


# --------------------------------------------------------------------- init


_STEM_SPECS = {
    "Conv2d_1a_3x3": (32, 3, 3), "Conv2d_2a_3x3": (32, 32, 3),
    "Conv2d_2b_3x3": (64, 32, 3), "Conv2d_3b_1x1": (80, 64, 1),
    "Conv2d_4a_3x3": (192, 80, 3),
}


def _a_specs(cin, pool):
    return {"branch1x1": (64, cin, 1), "branch5x5_1": (48, cin, 1),
            "branch5x5_2": (64, 48, 5), "branch3x3dbl_1": (64, cin, 1),
            "branch3x3dbl_2": (96, 64, 3), "branch3x3dbl_3": (96, 96, 3),
            "branch_pool": (pool, cin, 1)}


def _b_specs(cin):
    return {"branch3x3": (384, cin, 3), "branch3x3dbl_1": (64, cin, 1),
            "branch3x3dbl_2": (96, 64, 3), "branch3x3dbl_3": (96, 96, 3)}


def _c_specs(cin, c7):
    return {"branch1x1": (192, cin, 1),
            "branch7x7_1": (c7, cin, 1), "branch7x7_2": (c7, c7, (1, 7)),
            "branch7x7_3": (192, c7, (7, 1)),
            "branch7x7dbl_1": (c7, cin, 1), "branch7x7dbl_2": (c7, c7, (7, 1)),
            "branch7x7dbl_3": (c7, c7, (1, 7)), "branch7x7dbl_4": (c7, c7, (7, 1)),
            "branch7x7dbl_5": (192, c7, (1, 7)),
            "branch_pool": (192, cin, 1)}


def _d_specs(cin):
    return {"branch3x3_1": (192, cin, 1), "branch3x3_2": (320, 192, 3),
            "branch7x7x3_1": (192, cin, 1), "branch7x7x3_2": (192, 192, (1, 7)),
            "branch7x7x3_3": (192, 192, (7, 1)), "branch7x7x3_4": (192, 192, 3)}


def _e_specs(cin):
    return {"branch1x1": (320, cin, 1), "branch3x3_1": (384, cin, 1),
            "branch3x3_2a": (384, 384, (1, 3)), "branch3x3_2b": (384, 384, (3, 1)),
            "branch3x3dbl_1": (448, cin, 1), "branch3x3dbl_2": (384, 448, 3),
            "branch3x3dbl_3a": (384, 384, (1, 3)),
            "branch3x3dbl_3b": (384, 384, (3, 1)),
            "branch_pool": (192, cin, 1)}


_BLOCK_SPECS = {
    "Mixed_5b": _a_specs(192, 32), "Mixed_5c": _a_specs(256, 64),
    "Mixed_5d": _a_specs(288, 64), "Mixed_6a": _b_specs(288),
    "Mixed_6b": _c_specs(768, 128), "Mixed_6c": _c_specs(768, 160),
    "Mixed_6d": _c_specs(768, 160), "Mixed_6e": _c_specs(768, 192),
    "Mixed_7a": _d_specs(768), "Mixed_7b": _e_specs(1280),
    "Mixed_7c": _e_specs(2048),
}

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def init_inception_params(gen: torch.Generator, num_classes: int = 1008,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded weights at the JAX initialiser's scales (He-normal convs,
    identity BN, fc N(0, 0.02²)), drawn from `gen`; for tests and
    weightless runs."""
    dev = resolve_device(device)

    def randn(shape, std):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * std).to(dev)

    def basic(spec):
        cout, cin, k = spec
        kh, kw = (k, k) if isinstance(k, int) else k
        return {"conv_weight": randn((cout, cin, kh, kw),
                                     float(np.sqrt(2.0 / (cin * kh * kw)))),
                "bn": {"weight": torch.ones(cout, device=dev),
                       "bias": torch.zeros(cout, device=dev),
                       "running_mean": torch.zeros(cout, device=dev),
                       "running_var": torch.ones(cout, device=dev)}}

    params: Dict[str, Any] = {}
    for name, spec in _STEM_SPECS.items():
        params[name] = basic(spec)
    for bname, specs in _BLOCK_SPECS.items():
        params[bname] = {k: basic(v) for k, v in specs.items()}
    params["fc"] = {"weight": randn((num_classes, 2048), 0.02),
                    "bias": torch.zeros(num_classes, device=dev)}
    return params


def params_from_torch_state(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A torchvision inception_v3 state dict (numpy values; pytorch-fid's
    Inception-2015 weights use the same names) → the params tree of numpy
    arrays (`convert.params_from_numpy` puts it on a device). Without an fc
    the logits are zero (1008 classes)."""
    def basic(prefix):
        return {"conv_weight": state[f"{prefix}.conv.weight"],
                "bn": {k: state[f"{prefix}.bn.{k}"] for k in _BN_KEYS}}

    params: Dict[str, Any] = {}
    for name in _STEM_SPECS:
        params[name] = basic(name)
    for bname, specs in _BLOCK_SPECS.items():
        params[bname] = {k: basic(f"{bname}.{k}") for k in specs}
    if "fc.weight" in state:
        params["fc"] = {"weight": state["fc.weight"], "bias": state["fc.bias"]}
    else:
        params["fc"] = {"weight": np.zeros((1008, 2048), np.float32),
                        "bias": np.zeros((1008,), np.float32)}
    return params
