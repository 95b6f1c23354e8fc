"""The native checkpoint format: one .npz holding the flattened params tree
('mapping/fc0/weight', ...) plus a JSON-encoded GeneratorConfig. The same
format as `stylemc_tpu/io/native.py`, so either package reads the other's
files. Loads with zero pickle exposure."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..convert import params_from_numpy
from ..device import DeviceLike
from ..models.stylegan2.generator import GeneratorConfig


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_native(path: str, cfg: GeneratorConfig, params) -> None:
    np.savez(path, __config__=json.dumps(dataclasses.asdict(cfg)),
             **_flatten(params))


def load_native(path: str, device: DeviceLike = None
                ) -> Tuple[GeneratorConfig, Dict]:
    data = np.load(path, allow_pickle=False)
    cfg_dict = json.loads(str(data["__config__"]))
    if isinstance(cfg_dict.get("resample_filter"), list):
        cfg_dict["resample_filter"] = tuple(cfg_dict["resample_filter"])
    cfg = GeneratorConfig(**cfg_dict)
    flat = {k: data[k] for k in data.files if k != "__config__"}
    return cfg, params_from_numpy(_unflatten(flat), device)
