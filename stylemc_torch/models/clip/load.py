"""Load OpenAI CLIP checkpoints (TorchScript .pt archives or plain state
dicts) into (CLIPConfig, params) (counterpart of
`stylemc_tpu/models/clip/load.py`). The file path is given explicitly or
found in STYLEMC_CLIP_DIR."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...convert import params_from_numpy
from ...device import DeviceLike
from .model import CLIPConfig, config_from_torch_state, params_from_torch_state

_MODEL_FILES = {
    "ViT-B/32": "ViT-B-32.pt",
    "ViT-B/16": "ViT-B-16.pt",
    "RN50": "RN50.pt",
}


def _state_dict_from_file(path: str) -> Dict[str, np.ndarray]:
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if "state_dict" in sd:
            sd = sd["state_dict"]
    out = {k: v.detach().cpu().float().numpy() for k, v in sd.items()
           if isinstance(v, torch.Tensor)}
    # TorchScript archives keep these as buffers; they are not parameters
    for k in ("input_resolution", "context_length", "vocab_size"):
        out.pop(k, None)
    return out


def resolve_clip_path(name: str, clip_dir: Optional[str] = None
                      ) -> Optional[str]:
    clip_dir = clip_dir or os.environ.get("STYLEMC_CLIP_DIR")
    if clip_dir is None:
        return None
    fname = _MODEL_FILES.get(name, name.replace("/", "-") + ".pt")
    path = os.path.join(clip_dir, fname)
    return path if os.path.exists(path) else None


def load_clip(name_or_path: str, clip_dir: Optional[str] = None,
              device: DeviceLike = None) -> Tuple[CLIPConfig, Dict[str, Any]]:
    """name_or_path: 'ViT-B/32' | 'ViT-B/16' | an explicit file path. The
    params land on `device` (cuda unless the caller says otherwise)."""
    path = name_or_path if os.path.exists(name_or_path) else \
        resolve_clip_path(name_or_path, clip_dir)
    if path is None:
        raise FileNotFoundError(
            f"CLIP checkpoint {name_or_path!r} not found; set STYLEMC_CLIP_DIR "
            "to a directory containing the OpenAI .pt files")
    state = _state_dict_from_file(path)
    cfg = config_from_torch_state(state)
    return cfg, params_from_numpy(params_from_torch_state(state, cfg), device)
