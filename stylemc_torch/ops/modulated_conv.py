"""Style-modulated convolution (StyleGAN2), counterpart of
`stylemc_tpu/ops/modulated_conv.py`.

The unfused decomposition: modulate the input instead of the weight, so one
shared-weight convolution serves the whole batch,

    y[b] = dcoef[b] ⊙ conv(x[b] ⊙ s[b], W) (+ noise)
    dcoef[b, o] = rsqrt((s²ᵀ · Σ_k W²)[b, o] + 1e-8)

For bf16/fp16 inputs the weights are pre-scaled by 1/sqrt(in·kh·kw)/max|W|
per output channel and the styles by 1/max|s| per sample, which keeps the
intermediates in range; the fp32 path is untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from .conv2d_resample import conv2d_resample


def modulated_conv2d(
    x,                      # [N, C_in, H, W]
    weight,                 # [C_out, C_in, kh, kw]
    styles,                 # [N, C_in]
    noise=None,             # broadcastable to the output, or None
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter=None,
    demodulate: bool = True,
    flip_weight: bool = True,
    up_impl=None,
):
    n = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape
    assert tuple(styles.shape) == (n, in_channels), \
        (tuple(styles.shape), (n, in_channels))

    if x.dtype in (torch.bfloat16, torch.float16) and demodulate:
        wmax = weight.abs().amax(dim=(1, 2, 3), keepdim=True)
        weight = weight * (1.0 / np.sqrt(in_channels * kh * kw) / wmax)
        smax = styles.abs().amax(dim=1, keepdim=True)
        styles = styles / smax

    dcoefs = None
    if demodulate:
        w2 = weight.float().square().sum(dim=(2, 3))   # [O, I]
        s2 = styles.float().square()                   # [N, I]
        dcoefs = torch.rsqrt(s2 @ w2.T + 1e-8)         # [N, O]

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight,
                        up_impl=up_impl)

    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
