"""A configuration's weights, made from the run's seed on the device.

The result holds only tensors the benchmark made, in the port's param
layout; the program and the reference both read them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..reference import stylegan2
from . import weights


def make_generator(g: Dict[str, Any], seed: int, device,
                   w_avg_samples: int) -> Dict[str, Any]:
    """StyleGAN2 weights; w_avg (the truncation centre, and e4e's
    latent_avg) is the mean w of `w_avg_samples` seeded z, as training
    tracks it."""
    params = weights.make_model(weights.stylegan2_plan(g), device, seed,
                                "generator")
    z = torch.randn((w_avg_samples, g["z_dim"]), device=device,
                    generator=weights.generator_on(device, seed, "w_avg"))
    with torch.no_grad():
        params["mapping"]["w_avg"] = stylegan2.mapping(params, g, z).mean(0)
    return params


def make_models(config: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """{'generator': params, 'clip': {name: (params, cfg)}, 'arcface':
    (params, layout), 'e4e': (params, layout, taps)} for what the
    configuration names."""
    out: Dict[str, Any] = {"generator": make_generator(
        config["generator"], seed, device, config["w_avg_samples"])}
    if "clip" in config:
        out["clip"] = {name: (weights.make_model(
            weights.clip_plan(c), device, seed, f"clip {name}"), c)
            for name, c in config["clip"].items()}
    if "arcface" in config:
        plan, layout = weights.arcface_plan(config["arcface"])
        out["arcface"] = (weights.make_model(plan, device, seed, "arcface"),
                          layout)
    if "e4e" in config:
        e = config["e4e"]
        plan, layout = weights.e4e_plan(e, e["n_styles"])
        out["e4e"] = (weights.make_model(plan, device, seed, "e4e"), layout,
                      weights.e4e_taps(layout))
    return out
