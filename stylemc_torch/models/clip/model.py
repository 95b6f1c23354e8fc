"""OpenAI CLIP (ViT-B/32, ViT-B/16) in functional torch (counterpart of
`stylemc_tpu/models/clip/model.py`).

Image and text encoders with QuickGELU, pre-LN transformer blocks, a causal
text mask and EOT-token text pooling, over a params dict with the JAX
package's layout; `params_from_torch_state` maps the OpenAI state_dict
namespace (visual.*, transformer.*, token_embedding, ...) onto it.
Attention is a matmul plus a softmax, and the patch embedding a reshape plus
a matmul, as in the JAX package. The RN50 image tower is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...device import DeviceLike, resolve_device

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    # vision
    image_resolution: int
    vision_layers: Any           # int (ViT) or tuple (ResNet stage depths)
    vision_width: int
    vision_patch_size: Optional[int]  # None → ModifiedResNet
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size is not None

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64 if self.is_vit else self.vision_width * 32 // 64


CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig(embed_dim=512, image_resolution=224, vision_layers=12,
                           vision_width=768, vision_patch_size=32),
    "ViT-B/16": CLIPConfig(embed_dim=512, image_resolution=224, vision_layers=12,
                           vision_width=768, vision_patch_size=16),
    "RN50": CLIPConfig(embed_dim=1024, image_resolution=224,
                       vision_layers=(3, 4, 6, 3), vision_width=64,
                       vision_patch_size=None),
}


# ------------------------------------------------------------------ primitives


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def layer_norm(p, x, eps=1e-5):
    """Statistics in fp32, result cast back to the compute dtype (CLIP's
    LayerNorm under half precision does the same)."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    xn = (x32 - mu) * torch.rsqrt(var + eps)
    return (xn * p["weight"] + p["bias"]).to(dt)


def _linear(p, x):
    return x @ p["weight"].T.to(x.dtype) + p["bias"].to(x.dtype)


def multi_head_attention(p, x, n_heads: int, attn_mask=None):
    """torch.nn.MultiheadAttention-compatible self-attention.

    p: {in_proj_weight [3D,D], in_proj_bias [3D], out_proj: {weight, bias}}
    x: [B, L, D].
    """
    b, l, d = x.shape
    qkv = x @ p["in_proj_weight"].T.to(x.dtype) + \
        p["in_proj_bias"].to(x.dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    hd = d // n_heads

    def heads(t):
        return t.reshape(b, l, n_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = (q @ k.transpose(-1, -2)) / float(np.sqrt(hd))
    if attn_mask is not None:
        scores = scores + attn_mask.to(scores.dtype)
    attn = torch.softmax(scores, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, l, d)
    return _linear(p["out_proj"], out)


def residual_block(p, x, n_heads, attn_mask=None):
    x = x + multi_head_attention(p["attn"], layer_norm(p["ln_1"], x), n_heads,
                                 attn_mask)
    h = _linear(p["mlp"]["c_fc"], layer_norm(p["ln_2"], x))
    return x + _linear(p["mlp"]["c_proj"], quick_gelu(h))


def transformer(p, x, n_layers, n_heads, attn_mask=None):
    """n_layers residual blocks in order (a `lax.scan` in the JAX package)."""
    for i in range(n_layers):
        x = residual_block(p[f"resblock{i}"], x, n_heads, attn_mask)
    return x


# ----------------------------------------------------------------- ViT vision


def encode_image_vit(params, cfg: CLIPConfig, image):
    """image: [N, 3, R, R], CLIP-normalized. → [N, embed_dim].

    The patch embedding (stride == kernel size) is a space-to-depth reshape
    plus one matmul, as in the JAX package."""
    vp = params["visual"]
    ps = cfg.vision_patch_size
    n, c, r, _ = image.shape
    g = r // ps
    wgt = vp["conv1_weight"].to(image.dtype)  # [width, 3, ps, ps]
    w = wgt.shape[0]
    xb = image.reshape(n, c, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    x = xb.reshape(n, g * g, c * ps * ps) @ wgt.reshape(w, -1).T
    cls = vp["class_embedding"].to(x.dtype).expand(n, 1, w)
    x = torch.cat([cls, x], dim=1)
    x = x + vp["positional_embedding"].to(x.dtype)
    x = layer_norm(vp["ln_pre"], x)
    x = transformer(vp["transformer"], x, cfg.vision_layers, cfg.vision_heads)
    x = layer_norm(vp["ln_post"], x[:, 0, :])
    return x @ vp["proj"].to(x.dtype)


def encode_image(params, cfg: CLIPConfig, image):
    if cfg.is_vit:
        return encode_image_vit(params, cfg, image)
    raise NotImplementedError(
        "the RN50 image tower is not ported yet (ROADMAP A12b); use "
        "ViT-B/32 or ViT-B/16")


# ----------------------------------------------------------------------- text


def build_causal_mask(length: int, device=None):
    mask = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(mask, diagonal=1)


def encode_text(params, cfg: CLIPConfig, tokens):
    """tokens: [N, context_length] integers. → [N, embed_dim]."""
    dev = params["token_embedding"].device
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.to(device=dev, dtype=torch.long)
    else:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=dev)
    x = params["token_embedding"][tokens]
    x = x + params["positional_embedding"].to(x.dtype)
    mask = build_causal_mask(cfg.context_length, device=x.device)
    x = transformer(params["transformer"], x, cfg.transformer_layers,
                    cfg.transformer_heads, attn_mask=mask)
    x = layer_norm(params["ln_final"], x)
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return x @ params["text_projection"].to(x.dtype)


# ----------------------------------------------------------------------- init


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Random init in CLIP's scheme (the JAX package's scales), drawn from
    `gen`; for tests and weightless runs. Real use imports OpenAI weights
    via `params_from_torch_state`."""
    if not cfg.is_vit:
        raise NotImplementedError(
            "the RN50 image tower is not ported yet (ROADMAP A12b)")
    dev = resolve_device(device)

    def randn(shape, std):
        return (torch.randn(shape, generator=gen, device=gen.device)
                * std).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ln(d):
        return {"weight": torch.ones((d,), device=dev), "bias": zeros(d)}

    def linear(din, dout, std):
        return {"weight": randn((dout, din), std), "bias": zeros(dout)}

    def block(d):
        return {
            "attn": {
                "in_proj_weight": randn((3 * d, d), d ** -0.5),
                "in_proj_bias": zeros(3 * d),
                "out_proj": linear(d, d, d ** -0.5),
            },
            "ln_1": ln(d),
            "ln_2": ln(d),
            "mlp": {
                "c_fc": linear(d, 4 * d, (2 * d) ** -0.5),
                "c_proj": linear(4 * d, d, (4 * d) ** -0.5),
            },
        }

    w = cfg.vision_width
    ps = cfg.vision_patch_size
    grid = cfg.image_resolution // ps
    visual = {
        "conv1_weight": randn((w, 3, ps, ps), w ** -0.5),
        "class_embedding": randn((w,), w ** -0.5),
        "positional_embedding": randn((grid * grid + 1, w), w ** -0.5),
        "ln_pre": ln(w),
        "ln_post": ln(w),
        "proj": randn((w, cfg.embed_dim), w ** -0.5),
        "transformer": {f"resblock{i}": block(w)
                        for i in range(cfg.vision_layers)},
    }
    tw = cfg.transformer_width
    return {
        "visual": visual,
        "token_embedding": randn((cfg.vocab_size, tw), 0.02),
        "positional_embedding": randn((cfg.context_length, tw), 0.01),
        "transformer": {f"resblock{i}": block(tw)
                        for i in range(cfg.transformer_layers)},
        "ln_final": ln(tw),
        "text_projection": randn((tw, cfg.embed_dim), tw ** -0.5),
        "logit_scale": torch.tensor(float(np.log(1 / 0.07)), device=dev),
    }


# -------------------------------------------------------------- weight import


def params_from_torch_state(state: Dict[str, np.ndarray], cfg: CLIPConfig
                            ) -> Dict[str, Any]:
    """Map an OpenAI CLIP state_dict (numpy values) onto the params tree of
    numpy arrays (`convert.params_from_numpy` puts it on a device)."""
    if not cfg.is_vit:
        raise NotImplementedError(
            "the RN50 image tower is not ported yet (ROADMAP A12b)")
    t = state

    def block(prefix):
        return {
            "attn": {
                "in_proj_weight": t[f"{prefix}.attn.in_proj_weight"],
                "in_proj_bias": t[f"{prefix}.attn.in_proj_bias"],
                "out_proj": {"weight": t[f"{prefix}.attn.out_proj.weight"],
                             "bias": t[f"{prefix}.attn.out_proj.bias"]},
            },
            "ln_1": {"weight": t[f"{prefix}.ln_1.weight"],
                     "bias": t[f"{prefix}.ln_1.bias"]},
            "ln_2": {"weight": t[f"{prefix}.ln_2.weight"],
                     "bias": t[f"{prefix}.ln_2.bias"]},
            "mlp": {
                "c_fc": {"weight": t[f"{prefix}.mlp.c_fc.weight"],
                         "bias": t[f"{prefix}.mlp.c_fc.bias"]},
                "c_proj": {"weight": t[f"{prefix}.mlp.c_proj.weight"],
                           "bias": t[f"{prefix}.mlp.c_proj.bias"]},
            },
        }

    visual = {
        "conv1_weight": t["visual.conv1.weight"],
        "class_embedding": t["visual.class_embedding"],
        "positional_embedding": t["visual.positional_embedding"],
        "ln_pre": {"weight": t["visual.ln_pre.weight"],
                   "bias": t["visual.ln_pre.bias"]},
        "ln_post": {"weight": t["visual.ln_post.weight"],
                    "bias": t["visual.ln_post.bias"]},
        "proj": t["visual.proj"],
        "transformer": {
            f"resblock{i}": block(f"visual.transformer.resblocks.{i}")
            for i in range(cfg.vision_layers)
        },
    }
    return {
        "visual": visual,
        "token_embedding": t["token_embedding.weight"],
        "positional_embedding": t["positional_embedding"],
        "transformer": {f"resblock{i}": block(f"transformer.resblocks.{i}")
                        for i in range(cfg.transformer_layers)},
        "ln_final": {"weight": t["ln_final.weight"],
                     "bias": t["ln_final.bias"]},
        "text_projection": t["text_projection"],
        "logit_scale": t.get("logit_scale",
                             np.asarray(np.log(1 / 0.07), np.float32)),
    }


def config_from_torch_state(state: Dict[str, np.ndarray]) -> CLIPConfig:
    """Infer the CLIPConfig from a state dict (as clip.model.build_model
    does)."""
    if "visual.conv1.weight" in state and state["visual.conv1.weight"].shape[-1] > 3:
        vw = state["visual.conv1.weight"].shape[0]
        patch = state["visual.conv1.weight"].shape[-1]
        grid = int(round((state["visual.positional_embedding"].shape[0] - 1) ** 0.5))
        layers = len({k.split(".")[3] for k in state
                      if k.startswith("visual.transformer.resblocks.")})
        return CLIPConfig(
            embed_dim=state["text_projection"].shape[1],
            image_resolution=grid * patch, vision_layers=layers,
            vision_width=vw, vision_patch_size=patch,
            transformer_width=state["ln_final.weight"].shape[0],
            transformer_heads=state["ln_final.weight"].shape[0] // 64,
            transformer_layers=len({k.split(".")[2] for k in state
                                    if k.startswith("transformer.resblocks.")}),
        )
    counts = []
    for li in range(1, 5):
        n = len({k.split(".")[2] for k in state if k.startswith(f"visual.layer{li}.")})
        counts.append(n)
    vw = state["visual.conv1.weight"].shape[0] * 2
    spacial = int(round((state["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
    return CLIPConfig(
        embed_dim=state["visual.attnpool.c_proj.weight"].shape[0],
        image_resolution=spacial * 32, vision_layers=tuple(counts),
        vision_width=vw, vision_patch_size=None,
        transformer_width=state["ln_final.weight"].shape[0],
        transformer_heads=state["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in state
                                if k.startswith("transformer.resblocks.")}),
    )
