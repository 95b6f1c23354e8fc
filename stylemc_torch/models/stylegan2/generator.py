"""StyleGAN2-ADA generator in torch (counterpart of
`stylemc_tpu/models/stylegan2/generator.py`).

Pure functions over a params dict with the same layout as the JAX package:

  params = {
    'mapping': {'fc0': {'weight': [512,512], 'bias': [512]}, ..., 'w_avg': [512]},
    'synthesis': {
      'b4':   {'const': [C,4,4], 'conv1': LAYER, 'torgb': RGB},
      'b8':   {'conv0': LAYER, 'conv1': LAYER, 'torgb': RGB},
      ...
    },
  }
  LAYER = {'affine': {'weight': [C_in, w_dim], 'bias': [C_in]},
           'weight': [C_out, C_in, 3, 3], 'bias': [C_out],
           'noise_strength': scalar, 'noise_const': [res, res]}
  RGB   = {'affine': ..., 'weight': [3, C_in, 1, 1], 'bias': [3]}

`synthesis` consumes packed S-space styles [N, 26, 512] directly; `mapping`
and `w_to_s` produce them. The ToRGB skip chain's 2x upsample goes through
the hand-written CUDA kernels (`ops/kernels/upfirdn2d.py`): B1 forward and,
under autograd, B2 backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ...device import DeviceLike, resolve_device
from ...ops import bias_act, modulated_conv2d, setup_filter_np
from ...ops.kernels.upfirdn2d import upsample2d_kernel
from ...utils.profiling import profiled_function

# Packed S-space layout: 26 rows of width 512 — 2 rows for b4 (conv1, torgb)
# + 3 rows (conv0, conv1, torgb) per upper block, sized for a 1024 px
# generator.
N_STYLE_CHANNELS = 26
S_TRAINABLE_SPACE_CHANNELS = (2, 3, 5, 6, 8, 9, 11, 12)
S_NON_TRAINABLE_SPACE_CHANNELS = tuple(
    i for i in range(N_STYLE_CHANNELS) if i not in S_TRAINABLE_SPACE_CHANNELS
)
STYLE_DIM = 512


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """The same fields as the JAX package's config, so a native .npz written
    by either package loads in the other."""
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_fp16_res: int = 4
    conv_clamp: Optional[float] = 256.0
    mapping_layers: int = 8
    mapping_lr_multiplier: float = 0.01
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    # 'float32', or 'bfloat16' for the top num_fp16_res blocks
    low_precision_dtype: str = "float32"
    # fused up-conv form, "polyphase" | "pad_dilate" (None → polyphase)
    up_conv_impl: Optional[str] = None
    # checkpoint each upper block under autograd (torch.utils.checkpoint):
    # activations are recomputed in the backward pass instead of stored.
    # Only blocks at resolution >= remat_min_res. No effect without grad.
    remat: bool = False
    remat_min_res: int = 0

    @property
    def block_resolutions(self) -> List[int]:
        return [2 ** i for i in range(2, int(np.log2(self.img_resolution)) + 1)]

    def channels(self, res: int) -> int:
        return max(1, min(self.channel_base // res, self.channel_max))

    @property
    def num_ws(self) -> int:
        # one w per conv, plus one for the last torgb
        n = 0
        for res in self.block_resolutions:
            n += 1 if res == 4 else 2
        return n + 1

    @property
    def num_style_rows(self) -> int:
        """Occupied rows of the packed [*, 26, 512] layout."""
        return 2 + 3 * (len(self.block_resolutions) - 1)

    def block_dtype(self, res: int) -> torch.dtype:
        if self.low_precision_dtype == "float32":
            return torch.float32
        lowp_cutoff = self.img_resolution // (2 ** (self.num_fp16_res - 1))
        if res >= lowp_cutoff:
            return getattr(torch, self.low_precision_dtype)
        return torch.float32

    def temp_shapes(self) -> List[Tuple[int, int, int]]:
        """Per-block true style widths (conv0, conv1, torgb)."""
        shapes = []
        for res in self.block_resolutions:
            c = self.channels(res)
            c_in = self.channels(res // 2) if res > 4 else c
            shapes.append((c, c, c) if res == 4 else (c_in, c, c))
        return shapes


# ------------------------------------------------------------------ init


def _randn(gen: torch.Generator, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)


def _fc_init(gen, in_f, out_f, device, bias_init=0.0, lr_multiplier=1.0):
    # weights stored pre-divided by lr_multiplier, as ADA does; the runtime
    # gain lr_multiplier/sqrt(in_f) nets to unit-scale activations
    return {
        "weight": _randn(gen, (out_f, in_f), device) / lr_multiplier,
        "bias": torch.full((out_f,), float(bias_init), device=device),
    }


def init_generator_params(gen: torch.Generator, cfg: GeneratorConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Random init in the ADA scheme (unit normal weights; equalized-lr
    gains applied at run time), drawn from `gen`."""
    dev = resolve_device(device)
    mapping = {}
    for i in range(cfg.mapping_layers):
        mapping[f"fc{i}"] = _fc_init(gen, cfg.w_dim if i else cfg.z_dim,
                                     cfg.w_dim, dev,
                                     lr_multiplier=cfg.mapping_lr_multiplier)
    mapping["w_avg"] = torch.zeros((cfg.w_dim,), device=dev)

    def layer(c_in, c_out, res):
        return {
            "affine": _fc_init(gen, cfg.w_dim, c_in, dev, bias_init=1.0),
            "weight": _randn(gen, (c_out, c_in, 3, 3), dev),
            "bias": torch.zeros((c_out,), device=dev),
            "noise_strength": torch.zeros((), device=dev),
            "noise_const": _randn(gen, (res, res), dev),
        }

    synthesis = {}
    for res in cfg.block_resolutions:
        c_out = cfg.channels(res)
        c_in = cfg.channels(res // 2) if res > 4 else c_out
        block: Dict[str, Any] = {}
        if res == 4:
            block["const"] = _randn(gen, (c_out, 4, 4), dev)
        else:
            block["conv0"] = layer(c_in, c_out, res)
        block["conv1"] = layer(c_out, c_out, res)
        block["torgb"] = {
            "affine": _fc_init(gen, cfg.w_dim, c_out, dev, bias_init=1.0),
            "weight": _randn(gen, (cfg.img_channels, c_out, 1, 1), dev),
            "bias": torch.zeros((cfg.img_channels,), device=dev),
        }
        synthesis[f"b{res}"] = block
    return {"mapping": mapping, "synthesis": synthesis}


# ------------------------------------------------------------------ mapping


def _fc(params, x, activation="linear", lr_multiplier=1.0):
    """Equalized-lr fully connected layer: runtime weight gain
    lr_multiplier/sqrt(in_features), bias scaled by lr_multiplier."""
    w = params["weight"]
    w = w * (lr_multiplier / np.sqrt(w.shape[1]))
    b = params["bias"] * lr_multiplier
    y = x @ w.T.to(x.dtype)
    return bias_act(y, b.float(), dim=y.ndim - 1, act=activation)


def normalize_2nd_moment(x, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


@profiled_function(name="generator.mapping")
def mapping(params, cfg: GeneratorConfig, z, c=None,
            truncation_psi: float = 1.0,
            truncation_cutoff: Optional[int] = None):
    """z [N, z_dim] → broadcast ws [N, num_ws, w_dim]."""
    mp = params["mapping"]
    x = normalize_2nd_moment(z.float())
    if cfg.c_dim > 0 and c is not None:
        y = normalize_2nd_moment(_fc(mp["embed"], c.float()))
        x = torch.cat([x, y], dim=-1)
    for i in range(cfg.mapping_layers):
        x = _fc(mp[f"fc{i}"], x, activation="lrelu",
                lr_multiplier=cfg.mapping_lr_multiplier)
    ws = x[:, None, :].repeat(1, cfg.num_ws, 1)
    if truncation_psi != 1.0:
        w_avg = mp["w_avg"]
        if truncation_cutoff is None:
            ws = w_avg + truncation_psi * (ws - w_avg)
        else:
            head = w_avg + truncation_psi * (ws[:, :truncation_cutoff] - w_avg)
            ws = torch.cat([head, ws[:, truncation_cutoff:]], dim=1)
    return ws


# ------------------------------------------------------------------ W → S


def split_ws(cfg: GeneratorConfig, ws):
    """Per-block rows of broadcast ws (num_conv + 1 each), advancing by
    num_conv: each torgb reuses the next block's first w."""
    blocks = []
    w_idx = 0
    for res in cfg.block_resolutions:
        num_conv = 1 if res == 4 else 2
        blocks.append(ws[:, w_idx:w_idx + num_conv + 1, :])
        w_idx += num_conv
    return blocks


def _affine(params, w):
    return _fc(params, w, activation="linear")


def w_to_s(params, cfg: GeneratorConfig, ws):
    """ws [N, num_ws, w_dim] → packed S-space styles [N, 26, 512].

    Per block, the per-layer affine outputs are packed left-aligned into
    512-wide rows, zero-padded. The torgb rows hold affine(w) without the
    ToRGB weight gain, which synthesis applies.
    """
    styles = ws.new_zeros((ws.shape[0], N_STYLE_CHANNELS, STYLE_DIM),
                          dtype=torch.float32)
    idx = 0
    for res, cur in zip(cfg.block_resolutions, split_ws(cfg, ws)):
        bp = params["synthesis"][f"b{res}"]
        names = ("conv1", "torgb") if res == 4 else ("conv0", "conv1", "torgb")
        for row, name in enumerate(names):
            s = _affine(bp[name]["affine"], cur[:, row, :])
            styles[:, idx + row, :s.shape[-1]] = s
        idx += len(names)
    return styles


# ------------------------------------------------------------------ synthesis


def _layer_noise(lp, n, res, noise_mode, generator, device):
    if noise_mode == "const":
        return (lp["noise_const"] * lp["noise_strength"]).float()[None, None]
    if noise_mode == "random":
        gen_dev = generator.device if generator is not None else device
        z = torch.randn((n, 1, res, res), generator=generator,
                        dtype=torch.float32, device=gen_dev)
        return z.to(device) * lp["noise_strength"]
    assert noise_mode == "none", noise_mode
    return None


def _synthesis_layer(lp, x, style, resample_filter, up, dtype, noise,
                     gain=1.0, conv_clamp=256.0, up_impl=None):
    """One modulated 3x3 conv + noise + fused lrelu."""
    x = modulated_conv2d(
        x.to(dtype), lp["weight"], style, noise=noise, up=up, padding=1,
        resample_filter=resample_filter, demodulate=True,
        flip_weight=up == 1, up_impl=up_impl,
    )
    act_gain = float(np.sqrt(2)) * gain
    act_clamp = conv_clamp * gain if conv_clamp is not None else None
    return bias_act(x, lp["bias"], act="lrelu", gain=act_gain, clamp=act_clamp)


def _torgb_layer(lp, x, style, conv_clamp=256.0):
    weight_gain = 1.0 / np.sqrt(lp["weight"].shape[1])  # 1x1 kernel
    y = modulated_conv2d(x, lp["weight"], style * weight_gain,
                         demodulate=False)
    y = bias_act(y, lp["bias"], act="linear", clamp=conv_clamp)
    return y.float()


@profiled_function(name="generator.synthesis")
def synthesis(params, cfg: GeneratorConfig, styles,
              until_k: Optional[int] = None, noise_mode: str = "const",
              noise_generator: Optional[torch.Generator] = None,
              blend_masks: Optional[Dict[int, Any]] = None,
              xs_original: Optional[List[Any]] = None,
              return_features: bool = False):
    """Packed S-space styles [N, 26, 512] → image [N, C, R, R] (float32).

    Args:
      until_k: stop after block index k (partial-resolution rendering).
      noise_mode: 'const' | 'random' | 'none'. 'random' draws from
        `noise_generator` (the global generator when None).
      blend_masks: {resolution: mask [N or 1, 1, res, res], or a list of
        them applied in order} — blend the block's features toward
        `xs_original` there.
      xs_original: per-block features of an earlier
        `return_features=True` call.
      return_features: also return the per-block feature list.
    """
    n = styles.shape[0]
    dev = styles.device
    filt = setup_filter_np(cfg.resample_filter)
    temp_shapes = cfg.temp_shapes()

    def layer(lp, x, style, up, dtype, noise):
        return _synthesis_layer(lp, x, style, filt, up=up, dtype=dtype,
                                noise=noise, conv_clamp=cfg.conv_clamp,
                                up_impl=cfg.up_conv_impl)

    x = img = None
    xs = []
    styles_idx = 0
    for k, res in enumerate(cfg.block_resolutions):
        if until_k is not None and k > until_k:
            break
        bp = params["synthesis"][f"b{res}"]
        shapes = temp_shapes[k]
        dtype = cfg.block_dtype(res)

        if res == 4:
            x = bp["const"][None].expand(n, *bp["const"].shape).to(dtype)
            s_torgb = styles[:, styles_idx + 1, :shapes[2]]
            x = layer(bp["conv1"], x, styles[:, styles_idx, :shapes[1]], 1,
                      dtype, _layer_noise(bp["conv1"], n, res, noise_mode,
                                          noise_generator, dev))
            styles_idx += 2
            img = _torgb_layer(bp["torgb"], x, s_torgb,
                               conv_clamp=cfg.conv_clamp)
            xs.append(x)
            continue

        s_conv0 = styles[:, styles_idx, :shapes[0]]
        s_conv1 = styles[:, styles_idx + 1, :shapes[1]]
        s_torgb = styles[:, styles_idx + 2, :shapes[2]]
        styles_idx += 3
        # drawn outside the block so a checkpointed recompute sees the same
        noise0 = _layer_noise(bp["conv0"], n, res, noise_mode,
                              noise_generator, dev)
        noise1 = _layer_noise(bp["conv1"], n, res, noise_mode,
                              noise_generator, dev)

        masks = []
        if blend_masks and res in blend_masks and xs_original is not None:
            masks = blend_masks[res]
            if not isinstance(masks, (list, tuple)):
                masks = [masks]

        def upper_block(x, img, bp=bp, s_conv0=s_conv0, s_conv1=s_conv1,
                        s_torgb=s_torgb, dtype=dtype, noise0=noise0,
                        noise1=noise1, masks=masks, k=k):
            x = layer(bp["conv0"], x, s_conv0, 2, dtype, noise0)
            x = layer(bp["conv1"], x, s_conv1, 1, dtype, noise1)
            for m in masks:  # blend toward the original features, in order
                m = torch.as_tensor(m, device=dev).to(x.dtype)
                x = m * xs_original[k].to(x.dtype) + (1 - m) * x
            img = upsample2d_kernel(img, filt)
            img = img + _torgb_layer(bp["torgb"], x, s_torgb,
                                     conv_clamp=cfg.conv_clamp)
            return x, img

        if (cfg.remat and not masks and res >= cfg.remat_min_res
                and torch.is_grad_enabled()):
            x, img = torch.utils.checkpoint.checkpoint(
                upper_block, x, img, use_reentrant=False)
        else:
            x, img = upper_block(x, img)
        xs.append(x)

    if return_features:
        return xs, img
    return img


def inference_cfg(cfg: GeneratorConfig) -> GeneratorConfig:
    """cfg for forward-only use: pad_dilate up-convs unless the caller set
    an impl. Serving and the rendering CLIs call this."""
    if cfg.up_conv_impl is None:
        return dataclasses.replace(cfg, up_conv_impl="pad_dilate")
    return cfg


def generate(params, cfg: GeneratorConfig, z, truncation_psi: float = 1.0,
             noise_mode: str = "const",
             noise_generator: Optional[torch.Generator] = None):
    """z → image (mapping → w_to_s → synthesis)."""
    ws = mapping(params, cfg, z, truncation_psi=truncation_psi)
    styles = w_to_s(params, cfg, ws)
    return synthesis(params, cfg, styles, noise_mode=noise_mode,
                     noise_generator=noise_generator)


RESOLUTION_UNTIL_K = {256: 6, 512: 7, 1024: 8}
