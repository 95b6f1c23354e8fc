"""OpenAI CLIP (ViT-B/32, ViT-B/16, RN50) in functional torch (counterpart
of `stylemc_tpu/models/clip/model.py`).

Image and text encoders with QuickGELU, pre-LN transformer blocks, a causal
text mask and EOT-token text pooling, over a params dict with the JAX
package's layout; `params_from_torch_state` maps the OpenAI state_dict
namespace (visual.*, transformer.*, token_embedding, ...) onto it.
Attention is a matmul plus a softmax, and the patch embedding a reshape plus
a matmul, as in the JAX package. RN50's image tower is the ModifiedResNet:
a three-conv stem, bottlenecks that average-pool before their stride
(anti-aliasing), and an attention pool over the final grid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


# ------------------------------------------------------- ModifiedResNet (RN50)


def _conv(w, x, stride=1, padding=0):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(p, x, eps=1e-5):
    """Inference-mode batchnorm (running statistics)."""
    scale = p["weight"] * torch.rsqrt(p["running_var"] + eps)
    bias = p["bias"] - p["running_mean"] * scale
    return x * scale[None, :, None, None].to(x.dtype) + \
        bias[None, :, None, None].to(x.dtype)


def _avg_pool(x, k):
    return F.avg_pool2d(x, k, k)


def _bottleneck(p, x, stride=1):
    out = F.relu(_bn(p["bn1"], _conv(p["conv1_weight"], x)))
    out = F.relu(_bn(p["bn2"], _conv(p["conv2_weight"], out, padding=1)))
    if stride > 1:
        out = _avg_pool(out, stride)
    out = _bn(p["bn3"], _conv(p["conv3_weight"], out))
    identity = x
    if "downsample" in p:
        identity = x if stride == 1 else _avg_pool(x, stride)
        identity = _bn(p["downsample"]["1"],
                       _conv(p["downsample"]["0_weight"], identity))
    return F.relu(out + identity)


def _attention_pool(p, x, n_heads):
    """The mean token, added in front of the grid's tokens, attends to all
    of them; its output, projected, is the embedding."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h * w).permute(2, 0, 1)  # [HW, N, C]
    x = torch.cat([x.mean(dim=0, keepdim=True), x], dim=0)
    x = x + p["positional_embedding"][:, None, :].to(x.dtype)
    d = x.shape[-1]
    q = _linear(p["q_proj"], x[:1])
    k = _linear(p["k_proj"], x)
    v = _linear(p["v_proj"], x)
    hd = d // n_heads

    def heads(t):
        return t.permute(1, 0, 2).reshape(n, -1, n_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = (qh @ kh.transpose(-1, -2)) / float(np.sqrt(hd))
    out = torch.softmax(scores, dim=-1) @ vh
    out = out.transpose(1, 2).reshape(n, 1, d)[:, 0]
    return _linear(p["c_proj"], out)


def encode_image_resnet(params, cfg: CLIPConfig, image):
    """image: [N, 3, R, R], CLIP-normalized. → [N, embed_dim]."""
    vp = params["visual"]
    x = image
    for i in (1, 2, 3):
        x = F.relu(_bn(vp[f"bn{i}"], _conv(vp[f"conv{i}_weight"], x,
                                           stride=2 if i == 1 else 1,
                                           padding=1)))
    x = _avg_pool(x, 2)
    strides = (1, 2, 2, 2)
    for li, depth in enumerate(cfg.vision_layers):
        layer = vp[f"layer{li + 1}"]
        for bi in range(depth):
            x = _bottleneck(layer[f"{bi}"], x,
                            stride=strides[li] if bi == 0 else 1)
    return _attention_pool(vp["attnpool"], x, cfg.vision_heads)


def encode_image(params, cfg: CLIPConfig, image):
    if cfg.is_vit:
        return encode_image_vit(params, cfg, image)
    return encode_image_resnet(params, cfg, image)


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

    def bn(c):
        return {"weight": torch.ones((c,), device=dev), "bias": zeros(c),
                "running_mean": zeros(c),
                "running_var": torch.ones((c,), device=dev)}

    def bottleneck(cin, cmid, stride):
        p = {"conv1_weight": randn((cmid, cin, 1, 1), cin ** -0.5),
             "bn1": bn(cmid),
             "conv2_weight": randn((cmid, cmid, 3, 3), (cmid * 9) ** -0.5),
             "bn2": bn(cmid),
             "conv3_weight": randn((cmid * 4, cmid, 1, 1), cmid ** -0.5),
             "bn3": bn(cmid * 4)}
        if stride > 1 or cin != cmid * 4:
            p["downsample"] = {"0_weight": randn((cmid * 4, cin, 1, 1),
                                                 cin ** -0.5),
                               "1": bn(cmid * 4)}
        return p

    w = cfg.vision_width
    if cfg.is_vit:
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
    else:
        visual = {"conv1_weight": randn((w // 2, 3, 3, 3), 0.05),
                  "bn1": bn(w // 2),
                  "conv2_weight": randn((w // 2, w // 2, 3, 3), 0.05),
                  "bn2": bn(w // 2),
                  "conv3_weight": randn((w, w // 2, 3, 3), 0.05),
                  "bn3": bn(w)}
        cin = w
        for li, depth in enumerate(cfg.vision_layers):
            cmid = w * 2 ** li
            layer = {}
            for bi in range(depth):
                layer[f"{bi}"] = bottleneck(
                    cin, cmid, 2 if bi == 0 and li > 0 else 1)
                cin = cmid * 4
            visual[f"layer{li + 1}"] = layer
        spacial = cfg.image_resolution // 32
        visual["attnpool"] = {
            "positional_embedding": randn((spacial ** 2 + 1, cin),
                                          cin ** -0.5),
            "q_proj": linear(cin, cin, 0.02),
            "k_proj": linear(cin, cin, 0.02),
            "v_proj": linear(cin, cin, 0.02),
            "c_proj": linear(cin, cfg.embed_dim, 0.02),
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

    def bn(prefix):
        return {k: t[f"{prefix}.{k}"] for k in
                ("weight", "bias", "running_mean", "running_var")}

    if cfg.is_vit:
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
    else:
        visual = {}
        for i in (1, 2, 3):
            visual[f"conv{i}_weight"] = t[f"visual.conv{i}.weight"]
            visual[f"bn{i}"] = bn(f"visual.bn{i}")
        for li, depth in enumerate(cfg.vision_layers):
            layer = {}
            for bi in range(depth):
                pfx = f"visual.layer{li + 1}.{bi}"
                p = {}
                for ci in (1, 2, 3):
                    p[f"conv{ci}_weight"] = t[f"{pfx}.conv{ci}.weight"]
                    p[f"bn{ci}"] = bn(f"{pfx}.bn{ci}")
                if f"{pfx}.downsample.0.weight" in t:
                    p["downsample"] = {
                        "0_weight": t[f"{pfx}.downsample.0.weight"],
                        "1": bn(f"{pfx}.downsample.1")}
                layer[f"{bi}"] = p
            visual[f"layer{li + 1}"] = layer
        visual["attnpool"] = {
            "positional_embedding": t["visual.attnpool.positional_embedding"],
            **{name: {"weight": t[f"visual.attnpool.{name}.weight"],
                      "bias": t[f"visual.attnpool.{name}.bias"]}
               for name in ("q_proj", "k_proj", "v_proj", "c_proj")},
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
