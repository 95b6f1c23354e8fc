"""Write a legacy TensorFlow StyleGAN2 pickle from the port's params: a
(G, D, Gs) tuple of ``dnnlib.tflib.network.Network`` objects in the layout
`io/tf_legacy.py` reads (the inverse of its renames, transposes, flips and
offsets). No TensorFlow is needed, and the embedded build source is a
stub that raises if it is ever executed. Seeded generators and
discriminators written this way stand in for real TF checkpoints.
"""

from __future__ import annotations

import pickle
import sys
import types
from typing import Any, Dict

import numpy as np

EMBEDDED_SRC = "raise RuntimeError('executed embedded TF build source')\n"


def network_class():
    """A class that pickles under the global name
    ``dnnlib.tflib.network.Network``, registered in `sys.modules` (pickle
    looks the name up when it writes). Instances pickle as (class, state
    dict), the stream shape real TF checkpoints have."""
    mod = sys.modules.get("dnnlib.tflib.network")
    if mod is not None and hasattr(mod, "Network"):
        return mod.Network
    netmod = types.ModuleType("dnnlib.tflib.network")

    class Network:
        def __init__(self, **state):
            self.__dict__.update(state)

    Network.__module__ = "dnnlib.tflib.network"
    Network.__qualname__ = "Network"
    netmod.Network = Network
    tflib = types.ModuleType("dnnlib.tflib")
    tflib.network = netmod
    dnnlib = sys.modules.get("dnnlib") or types.ModuleType("dnnlib")
    dnnlib.tflib = tflib
    sys.modules.setdefault("dnnlib", dnnlib)
    sys.modules["dnnlib.tflib"] = tflib
    sys.modules["dnnlib.tflib.network"] = netmod
    return Network


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _oihw_to_hwio(w, flip=False):
    w = _np(w).transpose(2, 3, 1, 0)
    if flip:
        w = w[::-1, ::-1]
    return np.ascontiguousarray(w)


def tf_generator(Network, cfg, params: Dict[str, Any]):
    """A generator's params (torch or numpy leaves) → its TF network."""
    g = params["mapping"]
    map_vars = []
    for i in range(cfg.mapping_layers):
        map_vars.append((f"Dense{i}/weight", _np(g[f"fc{i}"]["weight"]).T))
        map_vars.append((f"Dense{i}/bias", _np(g[f"fc{i}"]["bias"])))

    syn_vars = []

    def put_conv(src, lp, noise_idx, flip):
        syn_vars.append((f"{src}/weight", _oihw_to_hwio(lp["weight"], flip)))
        syn_vars.append((f"{src}/bias", _np(lp["bias"])))
        syn_vars.append((f"{src}/noise_strength",
                         np.float32(_np(lp["noise_strength"]).reshape(()))))
        syn_vars.append((f"noise{noise_idx}",
                         _np(lp["noise_const"])[None, None]))
        syn_vars.append((f"{src}/mod_weight", _np(lp["affine"]["weight"]).T))
        syn_vars.append((f"{src}/mod_bias", _np(lp["affine"]["bias"]) - 1))

    def put_torgb(src, lp):
        syn_vars.append((f"{src}/weight", _oihw_to_hwio(lp["weight"])))
        syn_vars.append((f"{src}/bias", _np(lp["bias"])))
        syn_vars.append((f"{src}/mod_weight", _np(lp["affine"]["weight"]).T))
        syn_vars.append((f"{src}/mod_bias", _np(lp["affine"]["bias"]) - 1))

    b4 = params["synthesis"]["b4"]
    syn_vars.append(("4x4/Const/const", _np(b4["const"])[None]))
    put_conv("4x4/Conv", b4["conv1"], 0, flip=False)
    put_torgb("4x4/ToRGB", b4["torgb"])
    for r in cfg.block_resolutions[1:]:
        bp = params["synthesis"][f"b{r}"]
        lg = int(np.log2(r))
        put_conv(f"{r}x{r}/Conv0_up", bp["conv0"], lg * 2 - 5, flip=True)
        put_conv(f"{r}x{r}/Conv1", bp["conv1"], lg * 2 - 4, flip=False)
        put_torgb(f"{r}x{r}/ToRGB", bp["torgb"])

    static_kwargs = {
        "latent_size": cfg.z_dim, "dlatent_size": cfg.w_dim,
        "resolution": cfg.img_resolution, "num_channels": cfg.img_channels,
        "mapping_layers": cfg.mapping_layers,
        "fmap_base": cfg.channel_base // 2, "fmap_max": cfg.channel_max,
        "num_fp16_res": cfg.num_fp16_res, "conv_clamp": cfg.conv_clamp,
        "truncation_psi": 0.5,  # a kwarg the converter ignores
    }

    def component(name, func, variables):
        return Network(version=4, name=name, static_kwargs={},
                       build_module_src=EMBEDDED_SRC, build_func_name=func,
                       variables=variables, components={})

    return Network(
        version=4, name="G", static_kwargs=static_kwargs,
        build_module_src=EMBEDDED_SRC, build_func_name="G_main",
        variables=[("dlatent_avg", _np(g["w_avg"]))],
        components={"mapping": component("G_mapping", "G_mapping", map_vars),
                    "synthesis": component("G_synthesis", "G_synthesis",
                                           syn_vars)})


def tf_discriminator(Network, size: int, params: Dict[str, Any]):
    """A resnet discriminator's params → its TF network (fmap_base 16384,
    the channel multiplier 2 of `d_channels`)."""
    tvars = [(f"{size}x{size}/FromRGB/weight",
              _oihw_to_hwio(params["stem"]["weight"])),
             (f"{size}x{size}/FromRGB/bias", _np(params["stem"]["bias"]))]
    for i in range(int(np.log2(size)), 2, -1):
        r = 2 ** i
        bp = params[f"block{r}"]
        tvars += [
            (f"{r}x{r}/Conv0/weight", _oihw_to_hwio(bp["conv1"]["weight"])),
            (f"{r}x{r}/Conv0/bias", _np(bp["conv1"]["bias"])),
            (f"{r}x{r}/Conv1_down/weight",
             _oihw_to_hwio(bp["conv2"]["weight"])),
            (f"{r}x{r}/Conv1_down/bias", _np(bp["conv2"]["bias"])),
            (f"{r}x{r}/Skip/weight", _oihw_to_hwio(bp["skip_weight"])),
        ]
    tvars += [
        ("4x4/Conv/weight", _oihw_to_hwio(params["final_conv"]["weight"])),
        ("4x4/Conv/bias", _np(params["final_conv"]["bias"])),
        ("4x4/Dense0/weight", _np(params["final_linear1"]["weight"]).T),
        ("4x4/Dense0/bias", _np(params["final_linear1"]["bias"])),
        ("Output/weight", _np(params["final_linear2"]["weight"]).T),
        ("Output/bias", _np(params["final_linear2"]["bias"])),
    ]
    return Network(version=4, name="D",
                   static_kwargs={"resolution": size, "fmap_base": 16384,
                                  "structure": "resnet"},
                   build_module_src=EMBEDDED_SRC, build_func_name="D_main",
                   variables=tvars, components={})


def write_tf_pickle(path: str, cfg, g_params, d_params, d_size: int,
                    gs_params=None) -> str:
    """Write (G, D, Gs) to `path`; Gs defaults to G's params."""
    Network = network_class()
    nets = (tf_generator(Network, cfg, g_params),
            tf_discriminator(Network, d_size, d_params),
            tf_generator(Network, cfg, g_params if gs_params is None
                         else gs_params))
    with open(path, "wb") as f:
        pickle.dump(nets, f, protocol=4)
    return path
