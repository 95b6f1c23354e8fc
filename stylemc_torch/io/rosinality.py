"""Import rosinality-format StyleGAN2 weights (the e4e decoder format) into
the generator's params tree (counterpart of `stylemc_tpu/io/rosinality.py`).

Pure renaming suffices:
  * EqualLinear and the ADA FullyConnectedLayer apply the same run-time
    scaling (weight·lr_mul/sqrt(in), bias·lr_mul): the style MLP maps 1:1.
  * Demodulated convs: rosinality scales the weight by 1/sqrt(in·k²) before
    demodulation, which renormalizes the product, so the raw weight copies.
  * ToRGB: rosinality scales the weight by 1/sqrt(in), ADA the style: the
    same product.
  * Up-conv and ToRGB-skip geometry match ADA's conv2d_resample(up=2,
    padding=1) and upsample2d (gain 4).
  * FusedLeakyReLU(bias, 0.2)·sqrt(2) is bias_act's lrelu; rosinality has
    no conv clamp, so the config sets conv_clamp=None.

Name map (rosinality → ours):
  style.{i+1}.*              → mapping.fc{i}.*
  input.input [1,C,4,4]      → synthesis.b4.const
  conv1.*                    → synthesis.b4.conv1.*
  to_rgb1.*                  → synthesis.b4.torgb.*
  convs.{2m}/{2m+1}.*        → synthesis.b{2^(m+3)}.conv0/.conv1.*
  to_rgbs.{m}.*              → synthesis.b{2^(m+3)}.torgb.*
  noises.noise_{k}           → per-layer noise_const (layer order; a
                               missing key is zeros)
  latent_avg                 → mapping.w_avg
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy
from ..device import DeviceLike
from ..models.stylegan2.generator import GeneratorConfig


def config_for_rosinality(size: int, channel_multiplier: int = 2,
                          n_mlp: int = 8) -> GeneratorConfig:
    """rosinality's channel dict {64: 256·cm, ...} is ADA's channel_base
    16384·cm with channel_max 512."""
    return GeneratorConfig(
        img_resolution=size,
        channel_base=16384 * channel_multiplier,
        channel_max=512,
        conv_clamp=None,
        num_fp16_res=0,
        mapping_layers=n_mlp,
    )


def generator_params_from_rosinality(
        state: Dict[str, np.ndarray], size: int,
        channel_multiplier: int = 2) -> Tuple[GeneratorConfig, Dict[str, Any]]:
    """A rosinality g_ema state dict → (config, params tree of float32
    numpy arrays); `convert.params_from_numpy` puts it on a device."""
    n_mlp = len({k.split(".")[1] for k in state
                 if k.startswith("style.") and k.endswith(".weight")})
    cfg = config_for_rosinality(size, channel_multiplier, n_mlp=n_mlp or 8)
    t = {k: np.asarray(v, np.float32) for k, v in state.items()}

    mapping = {f"fc{i}": {"weight": t[f"style.{i + 1}.weight"],
                          "bias": t[f"style.{i + 1}.bias"]}
               for i in range(cfg.mapping_layers)}
    # a rosinality g_ema keeps no w_avg; e4e checkpoints ship latent_avg
    # beside it, which load_rosinality_pt puts here
    mapping["w_avg"] = t.get("w_avg", np.zeros((cfg.w_dim,), np.float32))

    def noise_const(idx, res):
        key = f"noises.noise_{idx}"
        if key in t:
            return t[key].reshape(res, res)
        return np.zeros((res, res), np.float32)

    def conv_layer(pfx, noise_idx, res):
        return {
            "affine": {"weight": t[f"{pfx}.conv.modulation.weight"],
                       "bias": t[f"{pfx}.conv.modulation.bias"]},
            "weight": t[f"{pfx}.conv.weight"][0],
            "bias": t[f"{pfx}.activate.bias"],
            "noise_strength": t[f"{pfx}.noise.weight"].reshape(()),
            "noise_const": noise_const(noise_idx, res),
        }

    def torgb_layer(pfx):
        return {
            "affine": {"weight": t[f"{pfx}.conv.modulation.weight"],
                       "bias": t[f"{pfx}.conv.modulation.bias"]},
            "weight": t[f"{pfx}.conv.weight"][0],
            "bias": t[f"{pfx}.bias"].reshape(-1),
        }

    synthesis = {"b4": {
        "const": t["input.input"][0],
        "conv1": conv_layer("conv1", 0, 4),
        "torgb": torgb_layer("to_rgb1"),
    }}
    noise_idx = 1
    for m, res in enumerate(cfg.block_resolutions[1:]):
        synthesis[f"b{res}"] = {
            "conv0": conv_layer(f"convs.{2 * m}", noise_idx, res),
            "conv1": conv_layer(f"convs.{2 * m + 1}", noise_idx + 1, res),
            "torgb": torgb_layer(f"to_rgbs.{m}"),
        }
        noise_idx += 2
    return cfg, {"mapping": mapping, "synthesis": synthesis}


def infer_rosinality_size(state: Dict[str, np.ndarray]) -> int:
    n_torgbs = len({k.split(".")[1] for k in state
                    if k.startswith("to_rgbs.")})
    return 4 * (2 ** n_torgbs)


def load_rosinality_pt(path: str, device: DeviceLike = None
                       ) -> Tuple[GeneratorConfig, Dict[str, Any]]:
    """(config, torch params on `device`) from a rosinality-layout generator
    checkpoint: the train.py dict ({"g_ema"/"g": state}, optional
    "latent_avg") or a bare state dict. Size and mapping depth come from
    the keys. Counterpart of `io.export.save_rosinality_pt`."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    latent_avg = None
    if isinstance(obj, dict):
        la = obj.get("latent_avg")
        if isinstance(la, torch.Tensor):
            latent_avg = la.detach().float().numpy()
        for k in ("g_ema", "g", "generator", "state_dict"):
            if k in obj and isinstance(obj[k], dict):
                obj = obj[k]
                break
    state = {n: v.detach().cpu().numpy() for n, v in obj.items()
             if isinstance(v, torch.Tensor)}
    if not any(n.startswith("convs.") or n == "input.input" for n in state):
        raise ValueError(
            f"{path} does not look like a rosinality generator checkpoint")
    cfg, tree = generator_params_from_rosinality(
        state, infer_rosinality_size(state))
    if latent_avg is not None:
        tree["mapping"]["w_avg"] = latent_avg
    return cfg, params_from_numpy(tree, device)
