from .upfirdn2d import (
    setup_filter,
    setup_filter_np,
    upfirdn2d,
    filter2d,
    upsample2d,
    downsample2d,
)
from .bias_act import bias_act, activation_funcs
from .conv2d_resample import conv2d_resample
from .modulated_conv import modulated_conv2d


def fma(a, b, c):
    """Fused multiply-add a·b + c."""
    return a * b + c


__all__ = [
    "setup_filter",
    "setup_filter_np",
    "upfirdn2d",
    "filter2d",
    "upsample2d",
    "downsample2d",
    "bias_act",
    "activation_funcs",
    "conv2d_resample",
    "modulated_conv2d",
    "fma",
]
