"""StyleGAN2 (the StyleGAN2-ADA generator) in plain PyTorch, as published.

The mapping network, the W to S affines packed into StyleMC's [N, 26, 512]
S-space layout, and the synthesis network with weight modulation and
demodulation done on the weights themselves (ADA's fused form: one grouped
convolution per layer), up-convolutions as a stride-2 transposed
convolution followed by the 4x4 FIR blur, and the ToRGB skip chain's 2x
upsample as zero insertion followed by the same FIR. Nothing here imports
the program; it reads the weights in the port's param layout (keys only).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
N_ROWS, ROW = 26, 512


def channels(g: Dict[str, Any], res: int) -> int:
    return max(1, min(g["channel_base"] // res, g["channel_max"]))


def block_resolutions(g: Dict[str, Any]) -> List[int]:
    return [2 ** i for i in range(2, int(math.log2(g["img_resolution"])) + 1)]


def fir(device) -> torch.Tensor:
    """The [1, 3, 3, 1] filter as a normalised 4x4 kernel, float32."""
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=torch.float64)
    f2 = torch.outer(f, f)
    return (f2 / f2.sum()).float().to(device)


def lrelu(x, gain=SQRT2):
    return F.leaky_relu(x, 0.2) * gain


def mapping(params, g, z, psi: float = 1.0) -> torch.Tensor:
    """z [N, z_dim] → w [N, w_dim] (2nd-moment normalised input, eight
    equalised-lr FC layers with leaky ReLU, truncation toward w_avg)."""
    mp = params["mapping"]
    lr = g["mapping_lr_multiplier"]
    x = z.float()
    x = x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(g["mapping_layers"]):
        fc = mp[f"fc{i}"]
        w = fc["weight"] * (lr / math.sqrt(fc["weight"].shape[1]))
        x = lrelu(F.linear(x, w, fc["bias"] * lr))
    if psi != 1.0:
        x = torch.lerp(mp["w_avg"][None], x, psi)
    return x


def num_ws(g) -> int:
    return 2 * len(block_resolutions(g))


def _affine(p, w):
    return F.linear(w, p["weight"] / math.sqrt(p["weight"].shape[1]),
                    p["bias"])


def w_to_s(params, g, ws) -> torch.Tensor:
    """ws [N, num_ws, w_dim] (or w [N, w_dim] for every row) → packed
    styles [N, 26, 512]: per block its layers' affine outputs in rows
    (b4: conv1, torgb; then conv0, conv1, torgb per block), zero padded.
    Layer l of the synthesis network reads w row l; each ToRGB reads the
    row after its block's last conv."""
    if ws.ndim == 2:
        ws = ws[:, None].expand(-1, num_ws(g), -1)
    out = ws.new_zeros((ws.shape[0], N_ROWS, ROW))
    row, w_idx = 0, 0
    for res in block_resolutions(g):
        bp = params["synthesis"][f"b{res}"]
        names = ("conv1",) if res == 4 else ("conv0", "conv1")
        for name in names:
            s = _affine(bp[name]["affine"], ws[:, w_idx])
            out[:, row, :s.shape[1]] = s
            row += 1
            w_idx += 1
        s = _affine(bp["torgb"]["affine"], ws[:, w_idx])
        out[:, row, :s.shape[1]] = s
        row += 1
    return out


def _modconv(x, weight, s, demodulate: bool, up: bool, f):
    """Per-sample modulated convolution as one grouped convolution."""
    n, c_in, h, w_ = x.shape
    c_out, _, k, _ = weight.shape
    w = weight[None] * s[:, None, :, None, None]
    if demodulate:
        w = w * torch.rsqrt(w.square().sum(dim=(2, 3, 4), keepdim=True)
                            + 1e-8)
    x = x.reshape(1, n * c_in, h, w_)
    if up:
        wt = w.transpose(1, 2).reshape(n * c_in, c_out, k, k)
        y = F.conv_transpose2d(x, wt, stride=2, groups=n)
        y = y.reshape(n, c_out, y.shape[2], y.shape[3])
        return _blur(y, f, pad=1, gain=4.0)
    y = F.conv2d(x, w.reshape(n * c_out, c_in, k, k), padding=k // 2,
                 groups=n)
    return y.reshape(n, c_out, h, w_)


def _blur(x, f, pad: int, gain: float):
    c = x.shape[1]
    x = F.pad(x, [pad, pad, pad, pad])
    kernel = (f * gain)[None, None].expand(c, 1, 4, 4)
    return F.conv2d(x, kernel, groups=c)


def upsample2x(x, f):
    """Zero insertion, pad (2, 1) per axis, the FIR at gain 4."""
    n, c, h, w = x.shape
    y = x.new_zeros((n, c, 2 * h, 2 * w))
    y[:, :, ::2, ::2] = x
    y = F.pad(y, [2, 1, 2, 1])
    kernel = (f * 4.0)[None, None].expand(c, 1, 4, 4)
    return F.conv2d(y, kernel, groups=c)


def _layer(lp, x, s, up, f, clamp):
    y = _modconv(x, lp["weight"], s, True, up, f)
    y = y + (lp["noise_const"] * lp["noise_strength"])[None, None]
    y = lrelu(y + lp["bias"][None, :, None, None])
    return y if clamp is None else y.clamp(-clamp, clamp)


def _torgb(lp, x, s, clamp):
    c_in = lp["weight"].shape[1]
    y = _modconv(x, lp["weight"], s / math.sqrt(c_in), False, False, None)
    y = y + lp["bias"][None, :, None, None]
    return y if clamp is None else y.clamp(-clamp, clamp)


def synthesis(params, g, styles, until_k: Optional[int] = None
              ) -> torch.Tensor:
    """Packed styles [N, 26, 512] → image [N, 3, R, R] (noise 'const')."""
    f = fir(styles.device)
    clamp = g["conv_clamp"]
    n = styles.shape[0]
    row = 0
    x = img = None
    for k, res in enumerate(block_resolutions(g)):
        if until_k is not None and k > until_k:
            break
        bp = params["synthesis"][f"b{res}"]
        c_out = channels(g, res)
        if res == 4:
            x = bp["const"][None].expand(n, -1, -1, -1)
            x = _layer(bp["conv1"], x, styles[:, row, :c_out], False, f,
                       clamp)
            img = _torgb(bp["torgb"], x, styles[:, row + 1, :c_out], clamp)
            row += 2
            continue
        c_in = channels(g, res // 2)
        x = _layer(bp["conv0"], x, styles[:, row, :c_in], True, f, clamp)
        x = _layer(bp["conv1"], x, styles[:, row + 1, :c_out], False, f,
                   clamp)
        img = upsample2x(img, f) + _torgb(bp["torgb"], x,
                                          styles[:, row + 2, :c_out], clamp)
        row += 3
    return img


def to_levels(img: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] in [-1, 1] → the unrounded uint8 level of each value,
    [N, H, W, 3]: x·127.5 + 128 clipped to [0, 255] (the served uint8 is
    this value truncated)."""
    return (img.permute(0, 2, 3, 1) * 127.5 + 128.0).clamp(0.0, 255.0)
