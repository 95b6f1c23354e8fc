"""The port's RN50 CLIP tower and StyleGAN-NADA losses against the JAX
package's, on the CPU (fp32).

The same weights (the JAX initialisers, carried over with
`params_from_numpy`) and the same numpy images go through both packages:

* RN50's `encode_image` at an RN50-shaped config (stages 3, 4, 6, 3 at
  width 8, 64² input), each stage's bottlenecks and the attention pool:
  value and image gradient 1e-5; the OpenAI state-dict import and the
  config inferred from it exactly equal; the seeded init's layout equal;
* each NADA loss (directional, global, angle, the RN50 texture loss, the
  composite `nada_loss`, the patch loss): value and gradient to the edited
  image 1e-5; `generate_patches` exactly equal, windows past the borders
  placed as `jax.lax.dynamic_slice` places them (a negative start counts
  from the end, then the window is clamped into the image).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemc_tpu.losses import clip_loss_nada as jnada
from stylemc_tpu.models import clip as jclip
from stylemc_tpu.models.clip import model as jmodel
from stylemc_torch import losses as tlosses
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.losses import clip_loss_nada as tnada
from stylemc_torch.models import clip as tclip
from stylemc_torch.models.clip import model as tmodel
from tiny import tiny_clip_models
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
# RN50's stage depths at width 8 (RN50: 64) and a 64² input (RN50: 224)
RN = dict(embed_dim=32, image_resolution=64, vision_layers=(3, 4, 6, 3),
          vision_width=8, vision_patch_size=None, transformer_width=64,
          transformer_heads=1, transformer_layers=1)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, atol=ATOL, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _trees_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.fixture(scope="module")
def rn50():
    """(JAX cfg, JAX params, port cfg, port params): one JAX RN50 build."""
    jcfg = jclip.CLIPConfig(**RN)
    jp = _perturb_bn(jclip.init_clip_params(jax.random.PRNGKey(3), jcfg),
                     np.random.RandomState(9))
    return jcfg, jp, tclip.CLIPConfig(**RN), params_from_numpy(jp, "cpu")


def _perturb_bn(tree, rs):
    """The tree with each BN's weight, bias and running statistics drawn
    away from the identity (the init's), so BN's fold shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "running_var" in v:
            c = np.asarray(v["weight"]).shape
            out[k] = {"weight": 1 + 0.1 * rs.randn(*c),
                      "bias": 0.1 * rs.randn(*c),
                      "running_mean": 0.1 * rs.randn(*c),
                      "running_var": 1 + 0.2 * rs.rand(*c)}
            out[k] = {n: a.astype(np.float32) for n, a in out[k].items()}
        elif isinstance(v, dict):
            out[k] = _perturb_bn(v, rs)
        else:
            out[k] = v
    return out


def _value_and_grad(jax_fn, torch_fn, x, v=None):
    """fn(x) and d(sum(fn(x)·v))/dx through both packages."""
    want = np.asarray(jax_fn(jnp.asarray(x)))
    v = np.ones_like(want) if v is None else v
    jgrad = jax.grad(lambda a: jnp.sum(jax_fn(a) * v))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = torch_fn(t)
    tgrad, = torch.autograd.grad(torch.sum(got * torch.from_numpy(v)), t)
    return got, want, tgrad, jgrad


def test_rn50_encode_image_and_gradient_match_jax(rn50):
    jcfg, jp, tcfg, tp = rn50
    x = _rand(0, 2, 3, 64, 64)
    v = _rand(1, 2, RN["embed_dim"])
    got, want, tg, jg = _value_and_grad(
        lambda a: jclip.encode_image(jp, jcfg, a),
        lambda a: tclip.encode_image(tp, tcfg, a), x, v)
    assert got.shape == (2, RN["embed_dim"])
    _close(got, want)
    _close(tg, jg)


def test_rn50_stages_match_jax(rn50):
    """Each bottleneck (strided ones with their anti-aliasing pool and
    downsample branch) and the attention pool, fed the same input."""
    jcfg, jp, tcfg, tp = rn50
    vj, vt = jp["visual"], tp["visual"]
    c = RN["vision_width"]
    x = np.abs(_rand(2, 2, c, 16, 16))
    for li, depth in enumerate(RN["vision_layers"]):
        for bi in range(depth):
            stride = (1, 2, 2, 2)[li] if bi == 0 else 1
            want = jmodel._bottleneck(vj[f"layer{li + 1}"][f"{bi}"],
                                      jnp.asarray(x), stride)
            got = tmodel._bottleneck(vt[f"layer{li + 1}"][f"{bi}"],
                                     torch.from_numpy(np.array(x)), stride)
            _close(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))
            x = np.asarray(want)
    assert x.shape == (2, c * 32, 2, 2)
    _close(tmodel._attention_pool(vt["attnpool"], torch.from_numpy(x),
                                  tcfg.vision_heads),
           jmodel._attention_pool(vj["attnpool"], jnp.asarray(x),
                                  jcfg.vision_heads))


def _rn_state(params, cfg):
    """The OpenAI state-dict names of an RN tree (numpy values)."""
    state = {}
    vp = params["visual"]

    def bn(prefix, p):
        state.update({f"{prefix}.{k}": np.asarray(v) for k, v in p.items()})

    for i in (1, 2, 3):
        state[f"visual.conv{i}.weight"] = np.asarray(vp[f"conv{i}_weight"])
        bn(f"visual.bn{i}", vp[f"bn{i}"])
    for li, depth in enumerate(cfg.vision_layers):
        for bi in range(depth):
            p, pfx = vp[f"layer{li + 1}"][f"{bi}"], f"visual.layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                state[f"{pfx}.conv{ci}.weight"] = np.asarray(
                    p[f"conv{ci}_weight"])
                bn(f"{pfx}.bn{ci}", p[f"bn{ci}"])
            if "downsample" in p:
                state[f"{pfx}.downsample.0.weight"] = np.asarray(
                    p["downsample"]["0_weight"])
                bn(f"{pfx}.downsample.1", p["downsample"]["1"])
    ap = vp["attnpool"]
    state["visual.attnpool.positional_embedding"] = np.asarray(
        ap["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        for k in ("weight", "bias"):
            state[f"visual.attnpool.{name}.{k}"] = np.asarray(ap[name][k])
    for pfx, blk in (("transformer.resblocks.0",
                      params["transformer"]["resblock0"]),):
        a = blk["attn"]
        state[f"{pfx}.attn.in_proj_weight"] = np.asarray(a["in_proj_weight"])
        state[f"{pfx}.attn.in_proj_bias"] = np.asarray(a["in_proj_bias"])
        for k in ("weight", "bias"):
            state[f"{pfx}.attn.out_proj.{k}"] = np.asarray(a["out_proj"][k])
            for ln in ("ln_1", "ln_2"):
                state[f"{pfx}.{ln}.{k}"] = np.asarray(blk[ln][k])
            for mm in ("c_fc", "c_proj"):
                state[f"{pfx}.mlp.{mm}.{k}"] = np.asarray(blk["mlp"][mm][k])
    state["token_embedding.weight"] = np.asarray(params["token_embedding"])
    state["positional_embedding"] = np.asarray(params["positional_embedding"])
    for k in ("weight", "bias"):
        state[f"ln_final.{k}"] = np.asarray(params["ln_final"][k])
    state["text_projection"] = np.asarray(params["text_projection"])
    state["logit_scale"] = np.asarray(params["logit_scale"])
    return state


def test_rn50_state_import_and_init_match_jax(rn50):
    jcfg, jp, tcfg, tp = rn50
    state = _rn_state(jp, jcfg)
    cfg = tmodel.config_from_torch_state(state)
    assert cfg == tcfg and cfg.__dict__ == \
        jmodel.config_from_torch_state(state).__dict__
    got = tmodel.params_from_torch_state(state, cfg)
    _trees_equal(got, jmodel.params_from_torch_state(state, jcfg))
    _trees_equal(got, params_to_numpy(tp))
    # the seeded init has JAX's layout, and RN50's full one encodes 224²
    init = tclip.init_clip_params(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jp)
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), init) == shapes
    full = tclip.CLIP_CONFIGS["RN50"]
    shapes = jax.eval_shape(lambda: jclip.init_clip_params(
        jax.random.PRNGKey(0), full))
    init = tclip.init_clip_params(torch.Generator().manual_seed(0), full,
                                  device="cpu")
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), init) == \
        jax.tree_util.tree_map(lambda v: tuple(v.shape), shapes)


# ------------------------------------------------------------------------ NADA


@pytest.fixture(scope="module")
def vit():
    cfg, jp = tiny_clip_models()["ViT-B/32"]
    return cfg, jp, tclip.CLIPConfig(**cfg.__dict__), params_from_numpy(jp,
                                                                         "cpu")


@pytest.fixture(scope="module")
def anchors(vit):
    jcfg, jp, tcfg, tp = vit
    ja = jnada.NADATextAnchors.create(jp, jcfg, "man", "woman",
                                      tokenizer=jclip.FallbackTokenizer())
    ta = tnada.NADATextAnchors.create(tp, tcfg, "man", "woman",
                                      tokenizer=tclip.FallbackTokenizer())
    return ja, ta


SRC = np.tanh(_rand(4, 2, 3, 64, 64))
TGT = np.tanh(_rand(5, 2, 3, 64, 64) * 0.5 + np.arctanh(SRC * 0.999))


def _loss_and_grad(jax_fn, torch_fn):
    """The loss and its gradient to the edited image, both packages."""
    jl, jg = jax.value_and_grad(jax_fn)(jnp.asarray(TGT))
    t = torch.tensor(TGT, requires_grad=True)
    tl = torch_fn(t)
    tg, = torch.autograd.grad(tl, t)
    _close(tl, jl)
    _close(tg, jg, atol=ATOL * max(1.0, float(np.abs(jg).max())))
    return float(tl.detach())


@pytest.mark.parametrize("name", ["direction", "direction_mse", "global",
                                  "angle"])
def test_clip_losses_match_jax(vit, anchors, name):
    jcfg, jp, tcfg, tp = vit
    ja, ta = anchors
    src_j, src_t = jnp.asarray(SRC), torch.from_numpy(SRC)
    fns = {
        "direction": (
            lambda x: jnada.clip_directional_loss_nada(jp, jcfg, src_j, x, ja),
            lambda x: tnada.clip_directional_loss_nada(tp, tcfg, src_t, x,
                                                       ta)),
        "direction_mse": (
            lambda x: jnada.clip_directional_loss_nada(jp, jcfg, src_j, x, ja,
                                                       "mse"),
            lambda x: tnada.clip_directional_loss_nada(tp, tcfg, src_t, x, ta,
                                                       "mse")),
        "global": (lambda x: jnada.global_clip_loss(jp, jcfg, x, ja),
                   lambda x: tnada.global_clip_loss(tp, tcfg, x, ta)),
        "angle": (lambda x: jnada.clip_angle_loss(jp, jcfg, src_j, x, ja),
                  lambda x: tnada.clip_angle_loss(tp, tcfg, src_t, x, ta)),
    }
    assert np.isfinite(_loss_and_grad(*fns[name]))


def test_cnn_feature_and_nada_loss_match_jax(vit, anchors, rn50):
    """The RN50 texture loss alone, and `nada_loss` with every term on
    (direction, global, manifold, texture)."""
    jcfg, jp, tcfg, tp = vit
    ja, ta = anchors
    rjcfg, rjp, rtcfg, rtp = rn50
    tex = np.tanh(_rand(6, 2, 3, 64, 64))
    _loss_and_grad(
        lambda x: jnada.cnn_feature_loss(rjp, rjcfg, jnp.asarray(tex), x),
        lambda x: tnada.cnn_feature_loss(rtp, rtcfg, torch.from_numpy(tex),
                                         x))
    kw = dict(lambda_direction=1.0, lambda_global=0.5, lambda_manifold=0.2,
              lambda_texture=0.3)
    _loss_and_grad(
        lambda x: jnada.nada_loss(jp, jcfg, jnp.asarray(SRC), x, ja,
                                  rn_params=rjp, rn_cfg=rjcfg,
                                  texture_image=jnp.asarray(tex), **kw),
        lambda x: tnada.nada_loss(tp, tcfg, torch.from_numpy(SRC), x, ta,
                                  rn_params=rtp, rn_cfg=rtcfg,
                                  texture_image=torch.from_numpy(tex), **kw))
    # the texture term needs its image and RN50; without them it is off
    assert float(tnada.nada_loss(tp, tcfg, torch.from_numpy(SRC),
                                 torch.from_numpy(TGT), ta,
                                 lambda_direction=0.0, lambda_texture=1.0)) \
        == 0.0


def test_generate_patches_and_patch_loss_match_jax(vit):
    jcfg, jp, tcfg, tp = vit
    # centres inside, on and past the borders
    centers = np.asarray([[32, 32], [4, 60], [63, 0], [-5, 70],
                          [20, 40], [60, 60]], np.int32)
    img = _rand(7, 2, 3, 64, 64)
    for size in (16, 33, 64):
        np.testing.assert_array_equal(
            tnada.generate_patches(torch.from_numpy(img),
                                   torch.from_numpy(centers), size).numpy(),
            np.asarray(jnada.generate_patches(jnp.asarray(img),
                                              jnp.asarray(centers), size)))
    dirs = _rand(8, 3, 32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _loss_and_grad(
        lambda x: jnada.patch_directional_loss(
            jp, jcfg, jnp.asarray(SRC), x, jnp.asarray(dirs),
            jnp.asarray(centers), 24),
        lambda x: tnada.patch_directional_loss(
            tp, tcfg, torch.from_numpy(SRC), x, torch.from_numpy(dirs),
            centers, 24))


def test_losses_export_what_jax_exports():
    """Every name of JAX's `losses/__init__.py` but the landmarks pair,
    which the port leaves in `losses.landmarks_loss` (exporting the
    function would hide the module of the same name)."""
    from stylemc_tpu import losses as jlosses

    names = set(jlosses.__all__) - {"landmarks_loss", "wing_loss"}
    assert names <= set(tlosses.__all__)
    for name in names:
        assert callable(getattr(tlosses, name)) or isinstance(
            getattr(tlosses, name), list)
