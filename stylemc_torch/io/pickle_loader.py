"""Safe ingestion of NVIDIA StyleGAN2-ADA `.pkl` checkpoints (counterpart of
`stylemc_tpu/io/pickle_loader.py`).

The loader never executes the Python source embedded in such a pickle: a
restricted Unpickler rebuilds tensors through an exact (module, name)
allow-list and replaces every persistent network object with an inert stub
carrying its `state`/`init_kwargs`, from which the params tree is assembled
by name.

Entry points:
  load_network_pkl(f)         → {'G': Stub, 'D': Stub, 'G_ema': Stub, ...}
  generator_from_stub(stub)   → (GeneratorConfig, numpy params tree)
  load_generator(path)        → (GeneratorConfig, torch params) for G_ema,
                                or from a native .npz / rosinality .pt
A legacy TensorFlow (G, D, Gs) pickle converts onto the same layout
(`io/tf_legacy.py`).
"""

from __future__ import annotations

import dataclasses
import io as _io
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..convert import params_from_numpy
from ..device import DeviceLike
from ..models.stylegan2.generator import GeneratorConfig
from .tf_legacy import (TFNetworkStub, convert_tf_discriminator,
                        convert_tf_generator, is_tf_network_tuple)


class EasyDict(dict):
    """Attribute-access dict (stands in for dnnlib.EasyDict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


class PersistentStub:
    """Inert stand-in for a pickle-embedded network module: the recorded
    constructor args and module state, never the embedded source."""

    def __init__(self, meta: dict):
        self.meta = meta
        self.class_name = meta.get("class_name")
        self.init_args = tuple(meta.get("state", {}).get("init_args", ()))
        self.init_kwargs = dict(meta.get("state", {}).get("init_kwargs", {}))
        self.state = meta.get("state", {})

    def named_tensors(self) -> Dict[str, np.ndarray]:
        """`_parameters`/`_buffers`/`_modules` flattened into dotted names →
        numpy arrays, the namespace a torch state_dict would have."""
        out: Dict[str, np.ndarray] = {}
        _walk_module_state(self.state, "", out)
        return out

    def __repr__(self):
        return f"PersistentStub({self.class_name})"


def _to_numpy(t) -> Optional[np.ndarray]:
    if isinstance(t, np.ndarray):
        return t
    if type(t).__module__.startswith("torch"):
        try:
            return t.detach().cpu().numpy()
        except (AttributeError, RuntimeError, TypeError):
            return None
    return None


def _walk_module_state(state: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(state, PersistentStub):
        _walk_module_state(state.state, prefix, out)
        return
    if isinstance(state, _StubBase):
        _walk_module_state(state.__dict__, prefix, out)
        return
    if not isinstance(state, dict):
        return
    for key in ("_parameters", "_buffers"):
        for name, val in (state.get(key) or {}).items():
            if val is None:
                continue
            arr = _to_numpy(val)
            if arr is not None:
                out[prefix + name] = arr
    for name, sub in (state.get("_modules") or {}).items():
        if sub is not None:
            _walk_module_state(sub, prefix + name + ".", out)


class _StubBase:
    """Generic stand-in for any class outside the allow-list."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.__dict__["_stub_init_args"] = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_stub_state"] = state

    # some pickles call methods during reconstruction; stay inert
    def __call__(self, *args, **kwargs):
        return None


def _reconstruct_persistent_stub(meta) -> PersistentStub:
    return PersistentStub(dict(meta))


def _safe_storage_from_bytes(b):
    """Replacement for torch.storage._load_from_bytes, whose stock version
    calls torch.load(weights_only=False) on the pickle's bytes. A legitimate
    pickled Storage is in torch's legacy format, which weights_only=True
    reads; anything else is rejected."""
    import torch
    return torch.load(_io.BytesIO(b), weights_only=True)


# Exact (module, name) allow-list of the reconstruction callables needed for
# NVIDIA network pickles. No prefix allow-list: whole module trees (numpy,
# torch.*) contain callables that execute code (numpy.testing.runstring,
# numpy.ctypeslib.load_library, torch.serialization.load).
_SAFE_EXACT = {
    ("builtins", "set"), ("builtins", "frozenset"), ("builtins", "list"),
    ("builtins", "dict"), ("builtins", "tuple"), ("builtins", "complex"),
    ("builtins", "bytearray"), ("builtins", "slice"), ("builtins", "range"),
    ("collections", "OrderedDict"),
    ("_codecs", "encode"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("torch._utils", "_rebuild_tensor"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch", "Size"), ("torch", "device"), ("torch", "dtype"),
}
_TORCH_DTYPE_NAMES = {
    "float32", "float64", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "bool",
}
_TORCH_STORAGE_NAMES = {
    "FloatStorage", "DoubleStorage", "HalfStorage", "BFloat16Storage",
    "LongStorage", "IntStorage", "ShortStorage", "CharStorage",
    "ByteStorage", "BoolStorage", "UntypedStorage",
}


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module.startswith("torch_utils.persistence")
                and name == "_reconstruct_persistent_obj"):
            return _reconstruct_persistent_stub
        if module == "dnnlib.tflib.network" and name == "Network":
            # a legacy TF pickle's network: an inert stub, the embedded
            # build source is never executed
            return TFNetworkStub
        if module.startswith("dnnlib") and name == "EasyDict":
            return EasyDict
        if module == "torch.storage" and name == "_load_from_bytes":
            return _safe_storage_from_bytes
        if (module, name) in _SAFE_EXACT:
            return super().find_class(module, name)
        if module == "torch" and (name in _TORCH_DTYPE_NAMES
                                  or name in _TORCH_STORAGE_NAMES):
            return super().find_class(module, name)
        # everything else (nn.Module subclasses, any other class): an inert
        # stub that keeps the recorded type name
        return type(f"Stub_{name}", (_StubBase,),
                    {"_pickle_type": (module, name)})


def load_network_pkl(f) -> Dict[str, Any]:
    """Parse an NVIDIA network pickle (path or binary file object) without
    executing embedded code; network objects become `PersistentStub`s. A
    legacy TensorFlow (G, D, Gs) pickle is converted onto the same
    {'G', 'D', 'G_ema'} layout."""
    if isinstance(f, (str, bytes)):
        with open(f, "rb") as fh:
            data = _SafeUnpickler(fh).load()
    else:
        data = _SafeUnpickler(f).load()
    if is_tf_network_tuple(data):
        tf_G, tf_D, tf_Gs = data
        data = {"G": convert_tf_generator(tf_G),
                "D": convert_tf_discriminator(tf_D),
                "G_ema": convert_tf_generator(tf_Gs),
                "training_set_kwargs": None, "augment_pipe": None}
    if not isinstance(data, dict):
        raise ValueError(f"unexpected pickle payload: {type(data)}")
    return data


# ------------------------------------------------------------ param assembly


def _config_from_stub(stub: PersistentStub) -> GeneratorConfig:
    kw = stub.init_kwargs
    syn_kw = dict(kw.get("synthesis_kwargs", {}))
    map_kw = dict(kw.get("mapping_kwargs", {}))
    return GeneratorConfig(
        z_dim=int(kw.get("z_dim", 512)),
        c_dim=int(kw.get("c_dim", 0)),
        w_dim=int(kw.get("w_dim", 512)),
        img_resolution=int(kw.get("img_resolution", 1024)),
        img_channels=int(kw.get("img_channels", 3)),
        channel_base=int(syn_kw.get("channel_base", 32768)),
        channel_max=int(syn_kw.get("channel_max", 512)),
        num_fp16_res=int(syn_kw.get("num_fp16_res", 4)),
        conv_clamp=syn_kw.get("conv_clamp", 256),
        mapping_layers=int(map_kw.get("num_layers", 8)),
    )


def generator_from_stub(stub: PersistentStub, force_fp16: bool = False
                        ) -> Tuple[GeneratorConfig, Dict]:
    """Assemble (config, numpy params tree) from a G/G_ema stub.

    Name mapping (torch state_dict namespace → params tree):
      mapping.fc{i}.{weight,bias}, mapping.w_avg, synthesis.b{res}.const,
      synthesis.b{res}.{conv0,conv1}.{affine.*,weight,bias,noise_strength,
      noise_const}, synthesis.b{res}.torgb.{affine.*,weight,bias}.
    resample_filter buffers are derived, not imported.
    """
    cfg = _config_from_stub(stub)
    if force_fp16:
        cfg = dataclasses.replace(cfg, num_fp16_res=4, conv_clamp=256)
    tensors = stub.named_tensors()

    def get(name, required=True):
        if name not in tensors:
            if required:
                raise KeyError(f"missing tensor {name!r}; available: "
                               f"{sorted(tensors)[:8]}...")
            return None
        return np.ascontiguousarray(tensors[name], dtype=np.float32)

    mapping = {f"fc{i}": {"weight": get(f"mapping.fc{i}.weight"),
                          "bias": get(f"mapping.fc{i}.bias")}
               for i in range(cfg.mapping_layers)}
    w_avg = get("mapping.w_avg", required=False)
    mapping["w_avg"] = (w_avg if w_avg is not None
                        else np.zeros((cfg.w_dim,), np.float32))
    if cfg.c_dim > 0:
        mapping["embed"] = {"weight": get("mapping.embed.weight"),
                            "bias": get("mapping.embed.bias")}

    def affine(pfx):
        return {"weight": get(f"{pfx}.affine.weight"),
                "bias": get(f"{pfx}.affine.bias")}

    def conv_layer(pfx):
        return {"affine": affine(pfx), "weight": get(f"{pfx}.weight"),
                "bias": get(f"{pfx}.bias"),
                "noise_strength": get(f"{pfx}.noise_strength").reshape(()),
                "noise_const": get(f"{pfx}.noise_const")}

    synthesis = {}
    for res in cfg.block_resolutions:
        b = f"synthesis.b{res}"
        block = {}
        if res == 4:
            block["const"] = get(f"{b}.const")
        else:
            block["conv0"] = conv_layer(f"{b}.conv0")
        block["conv1"] = conv_layer(f"{b}.conv1")
        block["torgb"] = {"affine": affine(f"{b}.torgb"),
                          "weight": get(f"{b}.torgb.weight"),
                          "bias": get(f"{b}.torgb.bias")}
        synthesis[f"b{res}"] = block
    return cfg, {"mapping": mapping, "synthesis": synthesis}


def load_generator(path, key: str = "G_ema", force_fp16: bool = False,
                   device: DeviceLike = None) -> Tuple[GeneratorConfig, Dict]:
    """(config, torch params on `device`) from an NVIDIA .pkl, a native
    .npz or a rosinality .pt/.pth."""
    if isinstance(path, str) and path.endswith(".npz"):
        from .native import load_native
        return load_native(path, device=device)
    if isinstance(path, str) and path.endswith((".pt", ".pth")):
        from .rosinality import load_rosinality_pt
        return load_rosinality_pt(path, device=device)
    data = load_network_pkl(path)
    stub = data[key]
    if not isinstance(stub, PersistentStub):
        raise ValueError(f"{key} is not a persistent network")
    cfg, tree = generator_from_stub(stub, force_fp16=force_fp16)
    return cfg, params_from_numpy(tree, device)
