"""The program's side of every driver: its config objects built from a
configuration file, and the inputs the benchmark hands it."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core import weights

TRAINABLE = (2, 3, 5, 6, 8, 9, 11, 12)


def generator_config(g: Dict[str, Any]):
    from stylemc_torch.models.stylegan2.generator import GeneratorConfig

    return GeneratorConfig(
        z_dim=g["z_dim"], w_dim=g["w_dim"], img_resolution=g["img_resolution"],
        img_channels=g["img_channels"], channel_base=g["channel_base"],
        channel_max=g["channel_max"], num_fp16_res=g["num_fp16_res"],
        conv_clamp=g["conv_clamp"], mapping_layers=g["mapping_layers"],
        mapping_lr_multiplier=g["mapping_lr_multiplier"],
        resample_filter=tuple(g["resample_filter"]))


def clip_models(models: Dict[str, Any]) -> Dict[str, tuple]:
    """{name: (the program's CLIPConfig, params)}."""
    from stylemc_torch.models.clip import CLIPConfig

    return {name: (CLIPConfig(**c), p)
            for name, (p, c) in models["clip"].items()}


def seeded_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(weights.model_seed(seed, name))


def directions(seed: int, names, scale: float, device
               ) -> Dict[str, torch.Tensor]:
    """Named S-space directions [1, 26, 512]: seeded normal rows at `scale`
    in the trainable rows, as a trained StyleMC direction has, zero
    elsewhere."""
    gen = weights.generator_on(device, seed, "directions")
    out = {}
    for name in names:
        d = torch.zeros((1, 26, 512), device=device)
        d[:, list(TRAINABLE)] = torch.randn(
            (1, len(TRAINABLE), 512), device=device, generator=gen) * scale
        out[name] = d
    return out


def photos(seed: int, n: int, size: int, device) -> np.ndarray:
    """`n` seeded uint8 photos [n, size, size, 3]: a smooth random field
    (bicubic from 8x8) plus pixel noise of 8 levels, made on the device."""
    gen = weights.generator_on(device, seed, "photos")
    low = torch.rand((n, 3, 8, 8), device=device, generator=gen) * 255
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode="bicubic", align_corners=False)
    img = img + torch.randn(img.shape, device=device, generator=gen) * 8
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def zs(seed: int, n: int, z_dim: int, device, name: str = "z"
       ) -> torch.Tensor:
    gen = weights.generator_on(device, seed, name)
    return torch.randn((n, z_dim), device=device, generator=gen)
