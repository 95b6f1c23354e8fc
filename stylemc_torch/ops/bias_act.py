"""Bias + activation + gain + clamp, with the nine-activation table and its
default alpha and gain (counterpart of `stylemc_tpu/ops/bias_act.py`).
Plain torch ops."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class _ActSpec(NamedTuple):
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, alpha: torch.relu(x), 0.0, float(np.sqrt(2))),
    "lrelu": _ActSpec(
        lambda x, alpha: torch.where(x >= 0, x, x * alpha), 0.2,
        float(np.sqrt(2))),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0,
                      float(np.sqrt(2))),
}


def bias_act(x, b=None, dim: int = 1, act: str = "linear",
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None):
    """Add `b` along `dim`, apply `act`, scale by `gain`, clamp to
    [-clamp, clamp]. Unset alpha and gain take the activation's defaults
    (lrelu: alpha 0.2, gain sqrt(2))."""
    assert clamp is None or clamp >= 0
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)

    if b is not None:
        assert b.ndim == 1
        assert 0 <= dim < x.ndim
        assert b.shape[0] == x.shape[dim]
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)

    x = spec.func(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return x
