"""The face parser's seeded weights, made on the device in the port's
DeepLab param layout (`stylemc_torch/models/deeplab.py`: `conv1_weight`,
`bn1`, `layer{1..4}.{i}` bottlenecks, `aspp`), from one draw as
`weights._Plan` makes every model's.

chenxi116/DeepLabv3.pytorch's initialisation: every convolution normal at
sqrt(2 / (k·k·out)), GroupNorm weight 1 and bias 0; the classifier's
weights at `classifier_scale` of that and its bias the configuration's
`classifier_bias` per class name, 0 elsewhere (`assumed` in the
configuration file).
"""

from __future__ import annotations

import math
from typing import Any, Dict

from ..reference.deeplab import CLASSES
from . import weights


def deeplab_plan(d: Dict[str, Any]) -> weights._Plan:
    p = weights._Plan()

    def conv(path, c_out, c_in, k, scale=1.0):
        p.randn(path, (c_out, c_in, k, k),
                scale * math.sqrt(2.0 / (k * k * c_out)))

    def gn(path, c):
        p.full(path + ("weight",), (c,), 1.0)
        p.full(path + ("bias",), (c,), 0.0)

    stem = d["stem"]
    conv(("conv1_weight",), stem, 3, 7)
    gn(("bn1",), stem)
    c_in = stem
    for li, (depth, width) in enumerate(zip(d["layers"], d["widths"])):
        c_out = width * d["expansion"]
        for bi in range(depth):
            b = (f"layer{li + 1}", f"{bi}")
            conv(b + ("conv1_weight",), width, c_in, 1)
            gn(b + ("bn1",), width)
            conv(b + ("conv2_weight",), width, width, 3)
            gn(b + ("bn2",), width)
            conv(b + ("conv3_weight",), c_out, width, 1)
            gn(b + ("bn3",), c_out)
            if bi == 0:
                conv(b + ("downsample", "0_weight"), c_out, c_in, 1)
                gn(b + ("downsample", "1"), c_out)
            c_in = c_out
    a, depth = ("aspp",), d["aspp_depth"]
    for i, k in ((1, 1), (2, 3), (3, 3), (4, 3), (5, 1)):
        conv(a + (f"aspp{i}_weight",), depth, c_in, k)
        gn(a + (f"aspp{i}_bn",), depth)
    conv(a + ("conv2_weight",), depth, 5 * depth, 1)
    gn(a + ("bn2",), depth)
    conv(a + ("conv3_weight",), d["classes"], depth, 1,
         d["classifier_scale"])
    p.full(a + ("conv3_bias",), (d["classes"],), 0.0)
    return p


def make_deeplab(config: Dict[str, Any], seed: int, device
                 ) -> Dict[str, Any]:
    d = config["deeplab"]
    params = weights.make_model(deeplab_plan(d), device, seed, "deeplab")
    for name, value in d["classifier_bias"].items():
        params["aspp"]["conv3_bias"][CLASSES.index(name)] = value
    return params
