"""Useful FLOPs of the face parser (DeepLabV3 over ResNet-101) from the
configuration's shapes: each multiply-add counted twice, for the stem,
every bottleneck's three convolutions and its strided shortcut, the ASPP
branches (the pooled branch at 1x1), its 1x1 projection and the
classifier. Norms, pooling, the upsample and the argmax are left out.
"""

from __future__ import annotations

from typing import Any, Dict


def _out(side: int, k: int, stride: int, pad: int) -> int:
    return (side + 2 * pad - k) // stride + 1


def deeplab_flop(config: Dict[str, Any]) -> int:
    """One image at the configuration's input size."""
    d = config["deeplab"]
    s = _out(d["input_size"], 7, 2, 3)
    total = 2 * 49 * 3 * d["stem"] * s * s
    s = _out(s, 3, 2, 1)
    c_in = d["stem"]
    for depth, width, stride in zip(d["layers"], d["widths"], d["strides"]):
        c_out = width * d["expansion"]
        for bi in range(depth):
            st = stride if bi == 0 else 1
            out = _out(s, 3, st, 1)
            total += 2 * c_in * width * s * s
            total += 2 * 9 * width * width * out * out
            total += 2 * width * c_out * out * out
            if bi == 0:
                total += 2 * c_in * c_out * out * out
            c_in, s = c_out, out
    a = d["aspp_depth"]
    branches = 1 + 9 * len(d["aspp_rates"])
    total += 2 * branches * c_in * a * s * s + 2 * c_in * a
    total += 2 * 5 * a * a * s * s + 2 * a * d["classes"] * s * s
    return total
