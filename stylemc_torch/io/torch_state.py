"""Read torch `.pth`/`.pt` state dicts into numpy without running pickled
code (`torch.load(weights_only=True)`): the ArcFace and e4e checkpoint
imports (counterpart of `stylemc_tpu/io/torch_state.py`)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def load_state_dict_numpy(path: str, key: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint as {name: np.ndarray}.

    Args:
      path: .pth/.pt/.tar file.
      key: optional sub-dict key (e.g. 'state_dict').
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        obj = obj[key]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    out = {}
    for name, val in obj.items():
        if isinstance(val, torch.Tensor):
            out[name] = val.detach().cpu().numpy()
        elif isinstance(val, np.ndarray):
            out[name] = val
    return out


def strip_prefix(state: Dict[str, np.ndarray], prefix: str
                 ) -> Dict[str, np.ndarray]:
    """The entries under `prefix`, with it stripped: the e4e checkpoint's
    `encoder.` / `decoder.` split."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in state.items() if k.startswith(prefix)}
