"""e4e / pSp encoders in torch (counterpart of
`stylemc_tpu/models/e4e/encoders.py`).

GradualStyleEncoder (an FPN over an IR-SE-50 body, one style head per W+
row), Encoder4Editing (w0 plus progressive per-row deltas) and
BackboneEncoderUsingLastLayerIntoW. The FPN taps the body at indices
6/20/23 and merges through a bilinear align_corners=True upsample and a 1x1
lateral conv; a style head is log2(spatial) stride-2 convs with
LeakyReLU(0.01), then an EqualLinear.

The bottleneck arithmetic is ArcFace's (`models/arcface.py`). The JAX
package resizes with two dense bilinear matrices; here the upsample is
`F.interpolate(mode="bilinear", align_corners=True)`, the reference's own
call: the same values, rounded in another order. JAX's vmapped head groups
are a plain loop over heads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...device import DeviceLike, resolve_device
from ..arcface import Layout, _conv, body_apply, ir_se_50_layout

COARSE_IND, MIDDLE_IND = 3, 7


def fpn_tap_indices(layout) -> tuple:
    """FPN tap indices (c1, c2, c3): the last block of each of the final
    three downsampling stages (a stage starts at every stride-2 block).
    IR-50 gives 6/20/23; a smaller body with four stride-2 stages keeps the
    64/32/16 tap planes the style heads assume at 256 px input."""
    starts = [i for i, (_, _, s) in enumerate(layout) if s == 2]
    if len(starts) < 3:
        raise ValueError("encoder layout needs >= 3 stride-2 stages")
    ends = [s - 1 for s in starts[1:]] + [len(layout) - 1]
    return tuple(ends[-3:])


def style_count(stylegan_size: int) -> int:
    return 2 * int(math.log2(stylegan_size)) - 2


# ------------------------------------------------------------- primitives


def equal_linear(p, x, lr_mul: float = 1.0):
    """rosinality EqualLinear (no activation): weight scaled by
    lr_mul/sqrt(in) and bias by lr_mul at run time."""
    w = p["weight"]
    scale = (1.0 / np.sqrt(w.shape[1])) * lr_mul
    return x @ (w * scale).T.to(x.dtype) + (p["bias"] * lr_mul).to(x.dtype)


def upsample_add(x, y):
    """x resized bilinearly (align_corners=True) to y's plane, plus y."""
    return F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                         align_corners=True) + y


def _conv_bias(p, x, stride=1, padding=0):
    y = _conv(x, p["weight"], stride=stride, padding=padding)
    return y + p["bias"][None, :, None, None].to(x.dtype)


def gradual_style_block(p, x, spatial: int):
    """log2(spatial) stride-2 convs + LeakyReLU(0.01), then EqualLinear."""
    for i in range(int(np.log2(spatial))):
        x = _conv_bias(p[f"conv{i}"], x, stride=2, padding=1)
        x = torch.where(x >= 0, x, 0.01 * x)
    return equal_linear(p["linear"], x.reshape(x.shape[0], -1))


# ------------------------------------------------------------- body


def _encoder_body(p, x, layout: Optional[Layout] = None):
    """IR-SE trunk with FPN taps: x [N,3,256,256] → (c1, c2, c3)."""
    layout = list(layout) if layout is not None else ir_se_50_layout()
    _, taps = body_apply(p, x, layout, taps=fpn_tap_indices(layout))
    return tuple(taps)


def _head_spatial(i: int) -> int:
    if i < COARSE_IND:
        return 16
    if i < MIDDLE_IND:
        return 32
    return 64


class _Features:
    """The style heads' inputs: c3 for the coarse rows, and the FPN levels
    p2 (middle rows) and p1 (fine rows), each built on first use."""

    def __init__(self, p, c1, c2, c3):
        self.p, self.c1, self.c2, self.c3 = p, c1, c2, c3
        self._p2 = self._p1 = None

    def p2(self):
        if self._p2 is None:
            self._p2 = upsample_add(self.c3,
                                    _conv_bias(self.p["latlayer1"], self.c2))
        return self._p2

    def p1(self):
        if self._p1 is None:
            self._p1 = upsample_add(self.p2(),
                                    _conv_bias(self.p["latlayer2"], self.c1))
        return self._p1

    def for_head(self, i: int):
        if i < COARSE_IND:
            return self.c3
        return self.p2() if i < MIDDLE_IND else self.p1()


def _head(p, feats: _Features, i: int):
    return gradual_style_block(p["styles"][f"{i}"], feats.for_head(i),
                               _head_spatial(i))


def gradual_style_encoder(p, x, stylegan_size: int = 1024,
                          layout: Optional[Layout] = None):
    """GradualStyleEncoder forward → W+ codes [N, S, 512]."""
    feats = _Features(p, *_encoder_body(p, x, layout))
    return torch.stack([_head(p, feats, i)
                        for i in range(style_count(stylegan_size))], dim=1)


def encoder4editing(p, x, stylegan_size: int = 1024,
                    progressive_stage: int = 18,
                    layout: Optional[Layout] = None):
    """Encoder4Editing forward → W+ codes [N, S, 512]: w0 in every row, plus
    a delta in rows 1 … min(progressive_stage + 1, S) - 1 (18 = inference:
    every row)."""
    n_styles = style_count(stylegan_size)
    c1, c2, c3 = _encoder_body(p, x, layout)
    feats = _Features(p, c1, c2, c3)
    w0 = gradual_style_block(p["styles"]["0"], c3, 16)
    stop = min(progressive_stage + 1, n_styles)
    rows = [w0] + [w0 + _head(p, feats, i) for i in range(1, stop)]
    rows += [w0] * (n_styles - len(rows))
    return torch.stack(rows, dim=1)


def backbone_encoder_into_w(p, x, stylegan_size: int = 1024,
                            layout: Optional[Layout] = None):
    """BackboneEncoderUsingLastLayerIntoW (SingleStyleCodeEncoder): one
    code from the pooled last features, in every row."""
    c3 = _encoder_body(p, x, layout)[2]
    w = equal_linear(p["linear"], c3.mean(dim=(2, 3)))
    return w[:, None, :].repeat(1, style_count(stylegan_size), 1)


# ------------------------------------------------------------- init / import


def init_encoder_params(gen: torch.Generator, stylegan_size: int = 1024,
                        encoder_type: str = "Encoder4Editing",
                        layout: Optional[Layout] = None,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """Random init in the JAX package's scheme, drawn from `gen`: the
    ArcFace body's (He-normal convs, identity BN, PReLU 0.25), head and
    lateral convs uniform in ±1/sqrt(fan_in) with zero bias, EqualLinear
    weights unit normal with zero bias."""
    from ..arcface import init_backbone_params

    dev = resolve_device(device)
    base = init_backbone_params(gen, input_size=112, layout=layout,
                                device=dev)
    lay = list(layout) if layout is not None else ir_se_50_layout()
    t1, t2, t3 = fpn_tap_indices(lay)
    # tap widths (IR-50: 128/256/512); heads and laterals run at c3's
    c1_ch, c2_ch, c3_ch = lay[t1][1], lay[t2][1], lay[t3][1]
    params = {k: base[k] for k in ("input_conv_weight", "input_bn",
                                   "input_prelu", "body")}

    def draw(shape, uniform_bound=None):
        if uniform_bound is None:
            v = torch.randn(shape, generator=gen, device=gen.device)
        else:
            v = (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1
                 ) * uniform_bound
        return v.to(dev)

    def conv_init(cin, cout, k):
        return {"weight": draw((cout, cin, k, k), 1.0 / np.sqrt(cin * k * k)),
                "bias": torch.zeros((cout,), device=dev)}

    def linear_init():
        return {"weight": draw((512, c3_ch)),
                "bias": torch.zeros((512,), device=dev)}

    if encoder_type == "SingleStyleCodeEncoder":
        params["linear"] = linear_init()
        return params
    styles = {}
    for i in range(style_count(stylegan_size)):
        head = {f"conv{j}": conv_init(c3_ch, c3_ch, 3)
                for j in range(int(np.log2(_head_spatial(i))))}
        head["linear"] = linear_init()
        styles[f"{i}"] = head
    params["styles"] = styles
    params["latlayer1"] = conv_init(c2_ch, c3_ch, 1)
    params["latlayer2"] = conv_init(c1_ch, c3_ch, 1)
    return params


def encoder_params_from_torch_state(state: Dict[str, np.ndarray],
                                    stylegan_size: int = 1024
                                    ) -> Dict[str, Any]:
    """Map the e4e encoder state_dict (input_layer.*, body.N.*, styles.N.*,
    latlayer{1,2}.*) onto the params tree of numpy arrays
    (`convert.params_from_numpy` puts it on a device)."""
    t = state

    def bn(prefix):
        return {k: t[f"{prefix}.{k}"] for k in
                ("weight", "bias", "running_mean", "running_var")}

    def conv(prefix):
        return {"weight": t[f"{prefix}.weight"], "bias": t[f"{prefix}.bias"]}

    params: Dict[str, Any] = {
        "input_conv_weight": t["input_layer.0.weight"],
        "input_bn": bn("input_layer.1"),
        "input_prelu": t["input_layer.2.weight"],
        "body": {},
    }
    for i, (in_c, depth, _) in enumerate(ir_se_50_layout()):
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

    if "linear.weight" in t:  # SingleStyleCodeEncoder
        params["linear"] = conv("linear")
        return params
    styles = {}
    for i in range(style_count(stylegan_size)):
        head = {f"conv{j}": conv(f"styles.{i}.convs.{2 * j}")
                for j in range(int(np.log2(_head_spatial(i))))}
        head["linear"] = conv(f"styles.{i}.linear")
        styles[f"{i}"] = head
    params["styles"] = styles
    params["latlayer1"] = conv("latlayer1")
    params["latlayer2"] = conv("latlayer2")
    return params
