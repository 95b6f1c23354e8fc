"""Perception-model loading from explicit local paths (counterpart of
`stylemc_tpu/utils/model_zoo.py`). Every weight file resolves from an
environment variable or an explicit path; `allow_random_init` substitutes
random weights, drawn from fixed seeds, so pipelines run without them.

Env vars:
  STYLEMC_CLIP_DIR      dir with OpenAI CLIP .pt files
  STYLEMC_CLIP_BPE      bpe_simple_vocab_16e6.txt.gz
  STYLEMC_ARCFACE       model_ir_se50.pth
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device


def load_clip_models(clip_type: str, allow_random_init: bool = False,
                     clip_dir: Optional[str] = None,
                     device: DeviceLike = None):
    """→ ({'ViT-B/32': (cfg, params), ...}, tokenizer). Random weights for
    the i-th model come from `torch.Generator().manual_seed(i)` on the CPU,
    so they are the same on every device."""
    from ..models.clip import CLIP_CONFIGS, init_clip_params
    from ..models.clip.load import load_clip, resolve_clip_path
    from ..models.clip.tokenizer import FallbackTokenizer, SimpleTokenizer

    dev = resolve_device(device)
    names = {"double": ["ViT-B/32", "ViT-B/16"],
             "large": ["ViT-B/16"],
             "small": ["ViT-B/32"]}[clip_type]

    models: Dict[str, Tuple] = {}
    for i, name in enumerate(names):
        path = resolve_clip_path(name, clip_dir)
        if path is not None:
            models[name] = load_clip(path, device=dev)
        elif allow_random_init:
            cfg = CLIP_CONFIGS[name]
            models[name] = (cfg, init_clip_params(
                torch.Generator().manual_seed(i), cfg, device=dev))
        else:
            raise FileNotFoundError(
                f"CLIP weights for {name} not found (set STYLEMC_CLIP_DIR, "
                "or pass --allow_random_init for smoke tests)")
    try:
        tokenizer = SimpleTokenizer()
    except FileNotFoundError:
        if not allow_random_init:
            raise FileNotFoundError(
                "CLIP BPE vocab not found (set STYLEMC_CLIP_BPE, or pass "
                "--allow_random_init for smoke tests)")
        tokenizer = FallbackTokenizer()
    return models, tokenizer


def load_arcface(path: Optional[str] = None, allow_random_init: bool = False,
                 device: DeviceLike = None):
    """IR-SE-50 params from `path` or STYLEMC_ARCFACE; random weights from
    `torch.Generator().manual_seed(42)` with `allow_random_init`."""
    from ..convert import params_from_numpy
    from ..io.torch_state import load_state_dict_numpy
    from ..models import arcface

    dev = resolve_device(device)
    path = path or os.environ.get("STYLEMC_ARCFACE")
    if path and os.path.exists(path):
        return params_from_numpy(arcface.params_from_torch_state(
            load_state_dict_numpy(path)), dev)
    if allow_random_init:
        return arcface.init_backbone_params(torch.Generator().manual_seed(42),
                                            device=dev)
    raise FileNotFoundError(
        "ArcFace weights not found (set STYLEMC_ARCFACE to model_ir_se50.pth, "
        "or pass --allow_random_init for smoke tests)")
