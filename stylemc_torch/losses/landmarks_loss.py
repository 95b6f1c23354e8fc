"""Facial-landmark losses on the 68-point layout, the jawline (points 0-16)
left out (counterpart of `stylemc_tpu/losses/landmarks_loss.py`).

WingLoss is the masked-elementwise form: the mean of the piecewise
function over every element, the value of the reference's
boolean-partition form."""

from __future__ import annotations

import numpy as np
import torch


def landmarks_loss(landmarks1: torch.Tensor, landmarks2: torch.Tensor
                   ) -> torch.Tensor:
    """MSE over landmarks[:, 17:]."""
    a = landmarks1[:, 17:].reshape(-1, 2)
    b = landmarks2[:, 17:].reshape(-1, 2)
    return torch.mean(torch.square(a - b))


def wing_loss(landmarks1: torch.Tensor, landmarks2: torch.Tensor,
              omega: float = 10.0, epsilon: float = 2.0) -> torch.Tensor:
    y = landmarks1[:, 17:].reshape(-1, 2)
    y_hat = landmarks2[:, 17:].reshape(-1, 2)
    d = torch.abs(y - y_hat)
    c = omega - omega * np.log(1 + omega / epsilon)
    piece = torch.where(d < omega, omega * torch.log1p(d / epsilon), d - c)
    return torch.mean(piece)
