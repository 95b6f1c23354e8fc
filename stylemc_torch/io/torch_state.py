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


class _EchoState(dict):
    """A state dict that holds every name, each mapped to itself."""

    def __missing__(self, key):
        return key

    def __contains__(self, key):
        return True

    def get(self, key, default=None):
        return key


def state_from_params(params_from_torch_state, params, *args
                      ) -> Dict[str, np.ndarray]:
    """The inverse of a name-mapping state converter: the state dict (numpy
    float32 values) that `params_from_torch_state(state, *args)` maps onto
    `params`. The converter is run on a state that echoes each name it
    reads, which gives the name of every leaf; names whose leaf `params`
    lacks are left out."""
    names = params_from_torch_state(_EchoState(), *args)
    out: Dict[str, np.ndarray] = {}

    def walk(name_tree, tree):
        if isinstance(name_tree, dict):
            for k, sub in name_tree.items():
                if k in tree:
                    walk(sub, tree[k])
            return
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[name_tree] = np.array(tree, np.float32)

    walk(names, params)
    return out
