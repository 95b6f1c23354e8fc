"""Latent mapper network (counterpart of `stylemc_tpu/models/mapper.py`).

`Mapper` splits the 8 trainable S-space rows into a coarse (rows 0-3) and a
medium (rows 4-7) half, each through PixelNorm and then 5 × (Linear(512,
512) → LayerNorm([4, 512], no affine) → LeakyReLU(neg_slope)). Its
`state_dict` keys are the reference's own,
`{course,medium}_mapping.modulation_module_list.{i}.fc.{weight,bias}`
(with the reference's spelling 'course'), so a `mapper_{prompt}.pth` loads
with `load_state_dict`, and a file the port writes reads back in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device

N_MODULES = 5
HALF_ROWS = 4
PARTS = ("course_mapping", "medium_mapping")


class _ModulationModule(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        # skip_init: the weights are set by the caller, and the global RNG
        # stays untouched
        self.fc = nn.utils.skip_init(nn.Linear, dim, dim, device=device)


class _SubMapper(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.modulation_module_list = nn.ModuleList(
            [_ModulationModule(dim, device) for _ in range(N_MODULES)])


class Mapper(nn.Module):
    """The reference's Mapper: trainable styles [N, 8, 512] → delta
    [N, 8, 512] (`mapper_apply`)."""

    def __init__(self, dim: int = 512, device: DeviceLike = "cpu"):
        super().__init__()
        self.course_mapping = _SubMapper(dim, device)
        self.medium_mapping = _SubMapper(dim, device)

    def forward(self, x: torch.Tensor, neg_slope: float = 0.01
                ) -> torch.Tensor:
        return mapper_apply(self, x, neg_slope)


def pixel_norm(x: torch.Tensor, dim: int = 1, eps: float = 1e-8
               ) -> torch.Tensor:
    """rosinality's PixelNorm: x · rsqrt(mean(x²) + eps) over dim 1. For
    the mapper's [N, 4, 512] input that is the layer axis, not the channel
    axis, as in the reference."""
    return x * torch.rsqrt(torch.mean(torch.square(x), dim=dim, keepdim=True)
                           + eps)


def _sub_mapper(sub: _SubMapper, x: torch.Tensor, neg_slope: float
                ) -> torch.Tensor:
    x = pixel_norm(x)
    for m in sub.modulation_module_list:
        # LayerNorm([4, 512]) without affine: over the last two axes jointly
        x = F.layer_norm(m.fc(x), x.shape[-2:], eps=1e-5)
        x = F.leaky_relu(x, neg_slope)
    return x


def mapper_apply(mapper: Mapper, x: torch.Tensor, neg_slope: float = 0.01
                 ) -> torch.Tensor:
    """x: [N, 8, 512] trainable-row styles → delta [N, 8, 512]."""
    # one row-major layout whatever the caller's strides: the CPU GEMM's
    # sums follow the input's layout
    x = x.contiguous()
    coarse = _sub_mapper(mapper.course_mapping, x[:, :HALF_ROWS], neg_slope)
    medium = _sub_mapper(mapper.medium_mapping, x[:, HALF_ROWS:2 * HALF_ROWS],
                         neg_slope)
    return torch.cat([coarse, medium], dim=1)


def init_mapper_params(generator: torch.Generator, dim: int = 512,
                       device: DeviceLike = None) -> Mapper:
    """A Mapper with torch Linear's default weight draw, U(±1/√dim), from
    `generator` (a CPU generator: the draw is the same on every device) and
    zero biases, as the JAX initialiser sets them."""
    dev = resolve_device(device)
    mapper = Mapper(dim, device="cpu")
    bound = 1.0 / np.sqrt(dim)
    with torch.no_grad():
        for part in PARTS:
            for m in getattr(mapper, part).modulation_module_list:
                m.fc.weight.copy_(torch.rand((dim, dim), generator=generator)
                                  * (2 * bound) - bound)
                m.fc.bias.zero_()
    return mapper.to(dev)


def params_from_torch_state(state: Dict[str, np.ndarray],
                            device: DeviceLike = None) -> Mapper:
    """A reference state dict ({name: array or tensor}, the names of
    `Mapper.state_dict`) → a Mapper on `device`."""
    dim = int(np.shape(state[f"{PARTS[0]}.modulation_module_list.0.fc.bias"])
              [0])
    mapper = Mapper(dim, device="cpu")
    mapper.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                            for k, v in state.items()})
    return mapper.to(resolve_device(device))


def params_to_torch_state(mapper: Mapper) -> Dict[str, np.ndarray]:
    """The Mapper's weights as {reference name: float32 numpy array}."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in mapper.state_dict().items()}


def save_mapper(mapper: Mapper, path: str) -> None:
    """Write `mapper_{prompt}.pth`: a torch state dict of CPU tensors."""
    torch.save({k: v.detach().cpu() for k, v in mapper.state_dict().items()},
               path)


def load_mapper(path: str, device: DeviceLike = None) -> Mapper:
    """Read a `mapper_{prompt}.pth` (a reference or port state dict)."""
    from ..io import load_state_dict_numpy

    return params_from_torch_state(load_state_dict_numpy(path), device)


def as_mapper(mapper_or_state, device: Optional[torch.device] = None
              ) -> Mapper:
    """A Mapper on `device`, from a Mapper or a state dict."""
    if isinstance(mapper_or_state, Mapper):
        return mapper_or_state if device is None else \
            mapper_or_state.to(device)
    return params_from_torch_state(mapper_or_state, device)
