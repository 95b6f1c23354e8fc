"""Legacy TensorFlow StyleGAN2 pickles (counterpart of
`stylemc_tpu/io/tf_legacy.py`).

A legacy TF pickle is a 3-tuple ``(G, D, Gs)`` of
``dnnlib.tflib.network.Network`` objects; each carries ``static_kwargs``
(the TF constructor arguments), ``components`` (child networks) and
``variables`` (a list of ``(name, np.ndarray)`` pairs). The conversion
renames the TF variables onto the ADA namespace that
`pickle_loader.generator_from_stub` consumes, with the transposes, flips and
offsets of NVIDIA's legacy converter, and the discriminator onto the
rosinality namespace. No TensorFlow is needed: the safe unpickler
materializes each ``Network`` as an inert `TFNetworkStub`, and the embedded
build source is never executed.

Refused with a clear message: a pickle version below 4, the progressive
'orig' architecture (``ToRGB_lod``/``FromRGB_lod`` variables), conditional
discriminators, unknown kwargs, and any kwarg whose value the generator
hard-codes differently (a non-lrelu activation, another resample kernel,
use_noise=False).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..device import DeviceLike


class TFNetworkStub:
    """Inert stand-in for ``dnnlib.tflib.network.Network``.

    The pickle's BUILD opcode fills ``__dict__`` with the network state:
    ``version``, ``name``, ``static_kwargs``, ``components``, ``variables``
    (and the embedded ``build_module_src``, which is never executed).
    """

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - malformed pickle
            self.__dict__["_state"] = state

    def __repr__(self):
        return f"TFNetworkStub({self.__dict__.get('name')})"


def is_tf_network_tuple(data) -> bool:
    """True for the legacy TF pickle payload: a (G, D, Gs) tuple."""
    return (isinstance(data, tuple) and len(data) == 3
            and all(isinstance(n, TFNetworkStub) for n in data))


def collect_tf_params(tf_net: TFNetworkStub) -> Dict[str, np.ndarray]:
    """Flatten ``variables`` across ``components`` into ``prefix/name``
    keys."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix: str, net):
        for name, value in getattr(net, "variables", []) or []:
            out[prefix + name] = np.asarray(value)
        comps = getattr(net, "components", None) or {}
        for name, comp in dict(comps).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


class _KwargReader:
    """static_kwargs reader that tracks consumption and rejects unknowns."""

    def __init__(self, tf_net: TFNetworkStub):
        self.kwargs = dict(getattr(tf_net, "static_kwargs", {}) or {})
        self.known: set = set()

    def get(self, name: str, default=None, none=None):
        self.known.add(name)
        val = self.kwargs.get(name, default)
        return val if val is not None else none

    def ignore(self, *names: str):
        self.known.update(names)

    def check_no_unknown(self):
        unknown = sorted(set(self.kwargs) - self.known)
        if unknown:
            raise ValueError(f"Unknown TensorFlow kwarg {unknown[0]!r}")


def _require(cond: bool, what: str):
    if not cond:
        raise NotImplementedError(f"TF pickle uses unsupported {what}")


def _check_version(tf_net: TFNetworkStub):
    if int(getattr(tf_net, "version", 0)) < 4:
        raise ValueError("TensorFlow pickle version too low")


# ------------------------------------------------------------------ generator


def convert_tf_generator(tf_G: TFNetworkStub):
    """TF generator network → `PersistentStub` in the ADA namespace, which
    `generator_from_stub` accepts."""
    from .pickle_loader import PersistentStub

    _check_version(tf_G)
    kw = _KwargReader(tf_G)
    init_kwargs = {
        "z_dim": kw.get("latent_size", 512),
        "c_dim": kw.get("label_size", 0),
        "w_dim": kw.get("dlatent_size", 512),
        "img_resolution": kw.get("resolution", 1024),
        "img_channels": kw.get("num_channels", 3),
        "mapping_kwargs": {"num_layers": kw.get("mapping_layers", 8)},
        "synthesis_kwargs": {
            "channel_base": kw.get("fmap_base", 16384) * 2,
            "channel_max": kw.get("fmap_max", 512),
            "num_fp16_res": kw.get("num_fp16_res", 0),
            "conv_clamp": kw.get("conv_clamp", None),
        },
    }
    # kwargs the generator hard-codes: accept only the values it implements
    _require(kw.get("mapping_nonlinearity", "lrelu") == "lrelu",
             "mapping activation")
    _require(kw.get("nonlinearity", "lrelu") == "lrelu", "activation")
    _require(float(kw.get("mapping_lrmul", 0.01)) == 0.01, "mapping lr_mul")
    _require(list(kw.get("resample_kernel", [1, 3, 3, 1], none=[1, 3, 3, 1]))
             == [1, 3, 3, 1], "resample kernel")
    _require(bool(kw.get("use_noise", True)), "use_noise=False")
    _require(kw.get("architecture", "skip") == "skip", "architecture")
    _require(kw.get("label_fmaps") is None, "label_fmaps")
    _require(kw.get("mapping_fmaps") is None, "mapping_fmaps")
    kw.ignore("truncation_psi", "truncation_cutoff", "style_mixing_prob",
              "structure", "w_avg_beta")
    kw.check_no_unknown()

    tf_params = collect_tf_params(tf_G)
    for name in tf_params:
        # progressive-growing checkpoints need the 'orig' architecture,
        # which the generator does not implement
        _require(not name.startswith("ToRGB_lod"),
                 "'orig' (progressive) architecture")

    res = int(init_kwargs["img_resolution"])
    n_layers = int(init_kwargs["mapping_kwargs"]["num_layers"])

    def hwio_to_oihw(w, flip=False):
        w = np.asarray(w, np.float32)
        if flip:
            w = w[::-1, ::-1]
        return np.ascontiguousarray(w.transpose(3, 2, 0, 1))

    t: Dict[str, np.ndarray] = {}
    t["mapping.w_avg"] = tf_params["dlatent_avg"]
    if init_kwargs["c_dim"] > 0:
        t["mapping.embed.weight"] = tf_params["mapping/LabelEmbed/weight"].T
        t["mapping.embed.bias"] = tf_params["mapping/LabelEmbed/bias"]
    for i in range(n_layers):
        t[f"mapping.fc{i}.weight"] = tf_params[f"mapping/Dense{i}/weight"].T
        t[f"mapping.fc{i}.bias"] = tf_params[f"mapping/Dense{i}/bias"]

    def conv(dst: str, src: str, noise_idx: int, flip: bool):
        t[f"{dst}.weight"] = hwio_to_oihw(tf_params[f"{src}/weight"], flip)
        t[f"{dst}.bias"] = tf_params[f"{src}/bias"]
        t[f"{dst}.noise_strength"] = np.asarray(
            tf_params[f"{src}/noise_strength"], np.float32)
        t[f"{dst}.noise_const"] = tf_params[f"synthesis/noise{noise_idx}"][0, 0]
        t[f"{dst}.affine.weight"] = tf_params[f"{src}/mod_weight"].T
        t[f"{dst}.affine.bias"] = tf_params[f"{src}/mod_bias"] + 1

    def torgb(dst: str, src: str):
        t[f"{dst}.weight"] = hwio_to_oihw(tf_params[f"{src}/weight"])
        t[f"{dst}.bias"] = tf_params[f"{src}/bias"]
        t[f"{dst}.affine.weight"] = tf_params[f"{src}/mod_weight"].T
        t[f"{dst}.affine.bias"] = tf_params[f"{src}/mod_bias"] + 1

    t["synthesis.b4.const"] = tf_params["synthesis/4x4/Const/const"][0]
    conv("synthesis.b4.conv1", "synthesis/4x4/Conv", 0, flip=False)
    torgb("synthesis.b4.torgb", "synthesis/4x4/ToRGB")
    for r in [2 ** i for i in range(3, int(np.log2(res)) + 1)]:
        lg = int(np.log2(r))
        # Conv0_up kernels are stored for the TF transposed conv: flip HW
        conv(f"synthesis.b{r}.conv0", f"synthesis/{r}x{r}/Conv0_up",
             lg * 2 - 5, flip=True)
        conv(f"synthesis.b{r}.conv1", f"synthesis/{r}x{r}/Conv1",
             lg * 2 - 4, flip=False)
        torgb(f"synthesis.b{r}.torgb", f"synthesis/{r}x{r}/ToRGB")

    stub = PersistentStub({"class_name": "Generator",
                           "state": {"init_args": (),
                                     "init_kwargs": init_kwargs}})
    stub.named_tensors = lambda: t  # converted namespace replaces the walk
    return stub


# -------------------------------------------------------------- discriminator


def convert_tf_discriminator(tf_D: TFNetworkStub):
    """TF discriminator → `PersistentStub` whose tensors use the rosinality
    namespace, so `d_params_from_rosinality` assembles the params directly.
    The ADA resnet discriminator and the rosinality one are the same
    architecture (1x1 stem, residual down-blocks with 1/√2 skips, mbstd,
    a conv and two linears) with the same stored-weight conventions."""
    from .pickle_loader import PersistentStub

    _check_version(tf_D)
    kw = _KwargReader(tf_D)
    size = int(kw.get("resolution", 1024))
    fmap_base = int(kw.get("fmap_base", 16384))
    init_kwargs = {
        "size": size,
        "channel_multiplier": fmap_base / 8192,
        "img_channels": kw.get("num_channels", 3),
    }
    _require(kw.get("label_size", 0) == 0, "conditional discriminator")
    _require(kw.get("nonlinearity", "lrelu") == "lrelu", "activation")
    _require(list(kw.get("resample_kernel", [1, 3, 3, 1], none=[1, 3, 3, 1]))
             == [1, 3, 3, 1], "resample kernel")
    _require(kw.get("architecture", "resnet") == "resnet", "architecture")
    _require(kw.get("mbstd_num_features", 1) == 1, "mbstd_num_features")
    kw.ignore("structure", "num_fp16_res", "conv_clamp", "fmap_max",
              "mbstd_group_size", "mapping_layers", "mapping_fmaps",
              "mapping_lrmul", "freeze_layers")
    kw.check_no_unknown()

    tf_params = collect_tf_params(tf_D)
    for name in tf_params:
        _require(not name.startswith("FromRGB_lod"),
                 "'orig' (progressive) architecture")

    def hwio_to_oihw(w):
        return np.ascontiguousarray(
            np.asarray(w, np.float32).transpose(3, 2, 0, 1))

    t: Dict[str, np.ndarray] = {
        "convs.0.0.weight": hwio_to_oihw(tf_params[f"{size}x{size}/FromRGB/weight"]),
        "convs.0.1.bias": tf_params[f"{size}x{size}/FromRGB/bias"],
    }
    idx = 1
    for i in range(int(np.log2(size)), 2, -1):
        r = 2 ** i
        t[f"convs.{idx}.conv1.0.weight"] = hwio_to_oihw(
            tf_params[f"{r}x{r}/Conv0/weight"])
        t[f"convs.{idx}.conv1.1.bias"] = tf_params[f"{r}x{r}/Conv0/bias"]
        t[f"convs.{idx}.conv2.1.weight"] = hwio_to_oihw(
            tf_params[f"{r}x{r}/Conv1_down/weight"])
        t[f"convs.{idx}.conv2.2.bias"] = tf_params[f"{r}x{r}/Conv1_down/bias"]
        t[f"convs.{idx}.skip.1.weight"] = hwio_to_oihw(
            tf_params[f"{r}x{r}/Skip/weight"])
        idx += 1
    t["final_conv.0.weight"] = hwio_to_oihw(tf_params["4x4/Conv/weight"])
    t["final_conv.1.bias"] = tf_params["4x4/Conv/bias"]
    t["final_linear.0.weight"] = np.asarray(tf_params["4x4/Dense0/weight"]).T
    t["final_linear.0.bias"] = tf_params["4x4/Dense0/bias"]
    t["final_linear.1.weight"] = np.asarray(tf_params["Output/weight"]).T
    t["final_linear.1.bias"] = tf_params["Output/bias"]

    stub = PersistentStub({"class_name": "Discriminator",
                           "state": {"init_args": (),
                                     "init_kwargs": init_kwargs}})
    stub.named_tensors = lambda: t
    return stub


def discriminator_from_stub(stub, device: DeviceLike = None
                            ) -> Tuple[int, Dict[str, Any]]:
    """(size, params on `device`) from a discriminator stub: a converted
    TF stub (rosinality namespace) or an NVIDIA torch-pickle stub (the ADA
    namespace, `b{res}.*`)."""
    from ..models.stylegan2.discriminator import (d_params_from_ada,
                                                  d_params_from_rosinality)

    tensors = stub.named_tensors()
    kw = stub.init_kwargs
    size = int(kw.get("size") or kw.get("img_resolution") or 0)
    if not size:  # infer from the top-resolution stem name
        import re
        tops = [int(m.group(1)) for k in tensors
                if (m := re.fullmatch(r"b(\d+)\.fromrgb\.weight", k))]
        size = max(tops) if tops else 0
    assert size, "cannot determine discriminator resolution"
    if "b4.conv.weight" in tensors:
        return size, d_params_from_ada(tensors, size, device)
    return size, d_params_from_rosinality(tensors, size, device)
