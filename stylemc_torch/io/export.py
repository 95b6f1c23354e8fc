"""Checkpoint export: write torch-ecosystem formats from the params trees
(counterpart of `stylemc_tpu/io/export.py`; the same keys and tensors, so
the two packages write bit-equal files from equal params).

  - `ada_to_rosinality_state`: generator params → the rosinality g_ema
    state-dict namespace (the inverse of `io.rosinality`'s name map).
  - `save_rosinality_pt`: rosinality train.py checkpoint layout
    ({"g_ema": state}, plus "latent_avg" when known).
  - `encoder_to_torch_state` / `save_e4e_pt`: the e4e_ffhq_encode.pt
    format (a state_dict with encoder./decoder. prefixes, latent_avg and
    a plain-dict opts), which `models.e4e.psp.load_psp_from_checkpoint`
    reads back.

Leaves may be torch tensors (on any device) or numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.stylegan2.generator import GeneratorConfig

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.array(v)


def encoder_to_torch_state(p, n_styles: int = 14) -> Dict[str, np.ndarray]:
    """e4e encoder params (IR-SE-50 body) → the reference torch namespace:
    input_layer.*, body.N.*, styles.N.*, latlayer{1,2}.*."""
    from ..models.arcface import ir_se_50_layout

    state = {"input_layer.0.weight": _np(p["input_conv_weight"])}
    for k in _BN_KEYS:
        state[f"input_layer.1.{k}"] = _np(p["input_bn"][k])
    state["input_layer.2.weight"] = _np(p["input_prelu"])
    for i, (in_c, depth, _) in enumerate(ir_se_50_layout()):
        bp = p["body"][f"{i}"]
        for k in _BN_KEYS:
            state[f"body.{i}.res_layer.0.{k}"] = _np(bp["bn1"][k])
            state[f"body.{i}.res_layer.4.{k}"] = _np(bp["bn2"][k])
        state[f"body.{i}.res_layer.1.weight"] = _np(bp["conv1_weight"])
        state[f"body.{i}.res_layer.2.weight"] = _np(bp["prelu"])
        state[f"body.{i}.res_layer.3.weight"] = _np(bp["conv2_weight"])
        state[f"body.{i}.res_layer.5.fc1.weight"] = _np(bp["se"]["fc1_weight"])
        state[f"body.{i}.res_layer.5.fc2.weight"] = _np(bp["se"]["fc2_weight"])
        if in_c != depth:
            state[f"body.{i}.shortcut_layer.0.weight"] = \
                _np(bp["shortcut_conv_weight"])
            for k in _BN_KEYS:
                state[f"body.{i}.shortcut_layer.1.{k}"] = \
                    _np(bp["shortcut_bn"][k])
    for i in range(n_styles):
        hp = p["styles"][f"{i}"]
        n_convs = len([k for k in hp if k.startswith("conv")])
        for j in range(n_convs):
            state[f"styles.{i}.convs.{2 * j}.weight"] = \
                _np(hp[f"conv{j}"]["weight"])
            state[f"styles.{i}.convs.{2 * j}.bias"] = \
                _np(hp[f"conv{j}"]["bias"])
        state[f"styles.{i}.linear.weight"] = _np(hp["linear"]["weight"])
        state[f"styles.{i}.linear.bias"] = _np(hp["linear"]["bias"])
    for name in ("latlayer1", "latlayer2"):
        state[f"{name}.weight"] = _np(p[name]["weight"])
        state[f"{name}.bias"] = _np(p[name]["bias"])
    return state


def ada_to_rosinality_state(cfg: GeneratorConfig,
                            params) -> Dict[str, np.ndarray]:
    """Generator params → the rosinality g_ema namespace."""
    state = {}
    for i in range(cfg.mapping_layers):
        fc = params["mapping"][f"fc{i}"]
        state[f"style.{i + 1}.weight"] = _np(fc["weight"])
        state[f"style.{i + 1}.bias"] = _np(fc["bias"])
    syn = params["synthesis"]
    state["input.input"] = _np(syn["b4"]["const"])[None]

    def put_affine(pfx, lp):
        state[f"{pfx}.conv.weight"] = _np(lp["weight"])[None]
        state[f"{pfx}.conv.modulation.weight"] = _np(lp["affine"]["weight"])
        state[f"{pfx}.conv.modulation.bias"] = _np(lp["affine"]["bias"])

    def put_conv(pfx, lp, noise_idx):
        put_affine(pfx, lp)
        state[f"{pfx}.noise.weight"] = _np(lp["noise_strength"]).reshape(1)
        state[f"{pfx}.activate.bias"] = _np(lp["bias"])
        state[f"noises.noise_{noise_idx}"] = _np(lp["noise_const"])[None, None]

    def put_torgb(pfx, lp):
        put_affine(pfx, lp)
        state[f"{pfx}.bias"] = _np(lp["bias"]).reshape(1, 3, 1, 1)

    put_conv("conv1", syn["b4"]["conv1"], 0)
    put_torgb("to_rgb1", syn["b4"]["torgb"])
    ni = 1
    for m, res in enumerate(cfg.block_resolutions[1:]):
        put_conv(f"convs.{2 * m}", syn[f"b{res}"]["conv0"], ni)
        put_conv(f"convs.{2 * m + 1}", syn[f"b{res}"]["conv1"], ni + 1)
        put_torgb(f"to_rgbs.{m}", syn[f"b{res}"]["torgb"])
        ni += 2
    return state


def _tensors(state: Dict[str, np.ndarray], prefix: str = ""):
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


def save_rosinality_pt(path: str, cfg: GeneratorConfig, params,
                       latent_avg=None) -> str:
    """Write a rosinality-layout generator checkpoint: {"g_ema": state},
    plus "latent_avg" [512] when given (the mapping's w_avg by default)."""
    if latent_avg is None:
        latent_avg = params.get("mapping", {}).get("w_avg")
    ckpt = {"g_ema": _tensors(ada_to_rosinality_state(cfg, params))}
    if latent_avg is not None:
        ckpt["latent_avg"] = torch.from_numpy(np.ascontiguousarray(
            _np(latent_avg).astype(np.float32)))
    torch.save(ckpt, path)
    return path


def save_e4e_pt(path: str, encoder_params, decoder_cfg: GeneratorConfig,
                decoder_params, latent_avg,
                opts: Optional[Dict] = None) -> str:
    """Write the e4e_ffhq_encode.pt checkpoint format."""
    from ..models.e4e.encoders import style_count

    n_styles = style_count(decoder_cfg.img_resolution)
    state = _tensors(encoder_to_torch_state(encoder_params,
                                            n_styles=n_styles), "encoder.")
    state.update(_tensors(ada_to_rosinality_state(decoder_cfg,
                                                  decoder_params), "decoder."))
    ckpt = {
        "state_dict": state,
        "latent_avg": torch.from_numpy(np.ascontiguousarray(
            _np(latent_avg).astype(np.float32))),
        "opts": {"stylegan_size": decoder_cfg.img_resolution,
                 "encoder_type": "Encoder4Editing", **(opts or {})},
    }
    torch.save(ckpt, path)
    return path
