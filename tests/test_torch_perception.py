"""The port's perception stack against the JAX package's, on the CPU (fp32).

Same numpy inputs and the same weights (from the JAX initialisers, carried
over with `params_from_numpy`) through ArcFace IR-SE, the identity loss,
the CLIP ViT towers and the CLIP preprocessing of both packages: values and
image gradients agree to atol 1e-5 (fp32 summation order through up to a
dozen layers). The tokenizers agree token for token, and the checkpoint
loaders read the same files into the same parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabricate import fabricate_clip_dir
from stylemc_tpu.losses import clip_loss_nada as jnada
from stylemc_tpu.losses.id_loss import extract_feats as j_extract_feats
from stylemc_tpu.losses.id_loss import id_loss as j_id_loss
from stylemc_tpu.models import arcface as jarc
from stylemc_tpu.models import clip as jclip
from stylemc_tpu.models.clip import load as jload
from stylemc_tpu.utils import image as jimage
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.losses import clip_loss_nada as tnada
from stylemc_torch.losses.id_loss import extract_feats as t_extract_feats
from stylemc_torch.losses.id_loss import id_loss as t_id_loss
from stylemc_torch.models import arcface as tarc
from stylemc_torch.models import clip as tclip
from stylemc_torch.models.clip import load as tload
from stylemc_torch.utils import image as timage
from stylemc_torch.utils.model_zoo import load_arcface, load_clip_models
from tiny import TINY_ARCFACE_LAYOUT, tiny_arcface, tiny_clip_models
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, atol=ATOL, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _value_and_image_grad(jax_fn, torch_fn, x, v):
    """fn(x) and d(sum(fn(x)·v))/dx through both packages."""
    want = np.asarray(jax_fn(jnp.asarray(x)))
    jgrad = jax.grad(lambda a: jnp.sum(jax_fn(a) * v))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = torch_fn(t)
    tgrad, = torch.autograd.grad(torch.sum(got * torch.from_numpy(v)), t)
    return got, want, tgrad, jgrad


def _trees_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.fixture(scope="module")
def arc():
    jp = tiny_arcface()
    return jp, params_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def clips():
    return {name: (cfg, params, params_from_numpy(params, "cpu"))
            for name, (cfg, params) in tiny_clip_models().items()}


# -------------------------------------------------------------------- ArcFace


def test_ir_se_50_layout_matches_jax():
    assert tarc.ir_se_50_layout() == jarc.ir_se_50_layout()


def test_arcface_backbone_matches_jax(arc):
    jp, tp = arc
    # the JAX tree's optional BatchNorm1d weight/bias are None leaves, which
    # params_from_numpy drops: the port reads a missing key as absent
    assert jp["output_bn1d"]["weight"] is None
    assert "weight" not in tp["output_bn1d"]
    x = _rand(1, 2, 3, 112, 112, scale=0.5)
    v = _rand(2, 2, 512)
    got, want, tgrad, jgrad = _value_and_image_grad(
        lambda a: jarc.backbone_apply(jp, a, layout=TINY_ARCFACE_LAYOUT),
        lambda a: tarc.backbone_apply(tp, a, layout=TINY_ARCFACE_LAYOUT),
        x, v)
    _close(got, want)
    _close(tgrad, jgrad)


def test_arcface_bn1d_with_affine_params(arc):
    _, tp = arc
    p = dict(tp["output_bn1d"], weight=torch.full((512,), 2.0),
             bias=torch.full((512,), 0.5))
    x = torch.from_numpy(_rand(3, 2, 512))
    want = jarc._bn1d({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                      jnp.asarray(x.numpy()))
    _close(tarc._bn1d(p, x), want)


@pytest.mark.parametrize("size", [64, 256])
def test_extract_feats_and_id_loss_match_jax(arc, size):
    jp, tp = arc
    x = _rand(4, 2, 3, size, size, scale=0.5)
    y = _rand(5, 2, 3, size, size, scale=0.5)
    v = _rand(6, 2, 512)
    got, want, tgrad, jgrad = _value_and_image_grad(
        lambda a: j_extract_feats(jp, a, TINY_ARCFACE_LAYOUT),
        lambda a: t_extract_feats(tp, a, TINY_ARCFACE_LAYOUT), x, v)
    _close(got, want)
    _close(tgrad, jgrad)

    jl, jg = jax.value_and_grad(lambda a: j_id_loss(
        jp, a, jnp.asarray(y), TINY_ARCFACE_LAYOUT))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    tl = t_id_loss(tp, t, torch.from_numpy(y), TINY_ARCFACE_LAYOUT)
    tg, = torch.autograd.grad(tl, t)
    _close(tl, jl)
    _close(tg, jg)


@pytest.mark.parametrize("shape", [(37, 11), (256, 112), (64, 256)])
def test_adaptive_avg_pool_matches_jax(shape):
    n_in, n_out = shape
    np.testing.assert_array_equal(timage.adaptive_avg_pool_matrix(n_in, n_out),
                                  jimage.adaptive_avg_pool_matrix(n_in, n_out))
    x = _rand(7, 2, 3, n_in, n_in)
    _close(timage.adaptive_avg_pool2d(torch.from_numpy(x), n_out, n_out),
           jimage.adaptive_avg_pool2d(jnp.asarray(x), n_out, n_out))


# ----------------------------------------------------------------------- CLIP


@pytest.mark.parametrize("name", ["ViT-B/32", "ViT-B/16"])
def test_clip_encode_image_matches_jax(clips, name):
    cfg, jp, tp = clips[name]
    x = _rand(8, 2, 3, 224, 224)
    v = _rand(9, 2, cfg.embed_dim)
    got, want, tgrad, jgrad = _value_and_image_grad(
        lambda a: jclip.encode_image(jp, cfg, a),
        lambda a: tclip.encode_image(tp, cfg, a), x, v)
    _close(got, want)
    _close(tgrad, jgrad)


@pytest.mark.parametrize("name", ["ViT-B/32", "ViT-B/16"])
def test_clip_encode_text_matches_jax(clips, name):
    cfg, jp, tp = clips[name]
    tok = jclip.FallbackTokenizer()
    tokens = jclip.tokenize(["a photo of a face", "a smiling old man"],
                            tokenizer=tok)
    _close(tclip.encode_text(tp, cfg, tokens),
           jclip.encode_text(jp, cfg, jnp.asarray(tokens)))
    # a token tensor is taken as it is
    _close(tclip.encode_text(tp, cfg, torch.from_numpy(tokens)),
           jclip.encode_text(jp, cfg, jnp.asarray(tokens)))


def test_clip_configs_match_jax():
    for name in ("ViT-B/32", "ViT-B/16", "RN50"):
        assert tclip.CLIP_CONFIGS[name].__dict__ == \
            jclip.CLIP_CONFIGS[name].__dict__


@pytest.mark.parametrize("size", [32, 256])
def test_unprocess_and_preprocess_nada_match_jax(size):
    x = _rand(10, 2, 3, size, size, scale=0.8)
    v = _rand(11, 2, 3, 224, 224)
    for jfn, tfn in ((jclip.unprocess, tclip.unprocess),
                     (jnada.preprocess_nada, tnada.preprocess_nada)):
        got, want, tgrad, jgrad = _value_and_image_grad(jfn, tfn, x, v)
        _close(got, want)
        _close(tgrad, jgrad)


def test_nada_text_anchors_match_jax(clips):
    cfg, jp, tp = clips["ViT-B/32"]
    tok = jclip.FallbackTokenizer()
    ja = jnada.NADATextAnchors.create(jp, cfg, "a face", "an old face",
                                      tokenizer=tok)
    ta = tnada.NADATextAnchors.create(tp, cfg, "a face", "an old face",
                                      tokenizer=tclip.FallbackTokenizer())
    for key in ("target_direction", "src_text_features",
                "target_text_features", "global_tokens"):
        _close(getattr(ta, key), getattr(ja, key))
    _close(tnada.compute_text_direction(tp, cfg, "a face", "an old face",
                                        tclip.FallbackTokenizer()),
           jnada.compute_text_direction(jp, cfg, "a face", "an old face", tok))
    x, y = _rand(12, 3, 32), _rand(13, 3, 32)
    for kind in ("cosine", "mse", "mae"):
        _close(tnada.direction_loss(torch.from_numpy(x), torch.from_numpy(y),
                                    kind),
               jnada.direction_loss(jnp.asarray(x), jnp.asarray(y), kind))


def test_clip_directional_loss_matches_jax(clips):
    from stylemc_tpu.losses import clip_loss as jcl
    from stylemc_torch.losses import clip_loss as tcl

    cfg, jp, tp = clips["ViT-B/32"]
    tokens = [jclip.tokenize([t], tokenizer=jclip.FallbackTokenizer())
              for t in ("a smiling face", "a face")]
    jd = jcl.make_text_direction(jp, cfg, *map(jnp.asarray, tokens))
    td = tcl.make_text_direction(tp, cfg, *tokens)
    _close(td, jd)
    src = _rand(14, 2, 3, 224, 224)
    tgt = _rand(15, 2, 3, 224, 224)
    jl, jg = jax.value_and_grad(lambda a: jcl.clip_directional_loss(
        jp, cfg, jnp.asarray(src), a, jd))(jnp.asarray(tgt))
    t = torch.tensor(tgt, requires_grad=True)
    tl = tcl.clip_directional_loss(tp, cfg, torch.from_numpy(src), t, td)
    tg, = torch.autograd.grad(tl, t)
    _close(tl, jl)
    _close(tg, jg)


# ------------------------------------------------------------------ tokenizer

TEXTS = ["a photo of a face of a feminine woman with no makeup",
         "The &amp; quick   brown FOX, 42 times!", "the man's face"]


def test_tokenizers_match_jax(tmp_path):
    d = fabricate_clip_dir(str(tmp_path / "clip"))
    bpe = str(tmp_path / "clip" / "bpe_simple_vocab_16e6.txt.gz")
    for jtok, ttok in ((jclip.FallbackTokenizer(), tclip.FallbackTokenizer()),
                       (jclip.SimpleTokenizer(bpe), tclip.SimpleTokenizer(bpe))):
        for text in TEXTS:
            assert ttok.encode(text) == jtok.encode(text)
        np.testing.assert_array_equal(
            tclip.tokenize(TEXTS, tokenizer=ttok),
            jclip.tokenize(TEXTS, tokenizer=jtok))
    assert d


# -------------------------------------------------------------------- loading


def test_load_clip_reads_the_jax_loaders_params(tmp_path):
    d = fabricate_clip_dir(str(tmp_path / "clip"))
    for fname in ("ViT-B-32.pt", "ViT-B-16.pt"):
        jcfg, jp = jload.load_clip(f"{d}/{fname}")
        tcfg, tp = tload.load_clip(f"{d}/{fname}", device="cpu")
        assert tcfg == tclip.CLIPConfig(**jcfg.__dict__)
        _trees_equal(params_to_numpy(tp),
                     jax.tree_util.tree_map(np.asarray, jp))


def _arcface_state(params):
    """The port's IR-SE-50 params in the model_ir_se50.pth namespace (the
    inverse of params_from_torch_state, as tests/test_losses.py writes it)."""
    p = params_to_numpy(params)
    state = {"input_layer.0.weight": p["input_conv_weight"],
             "input_layer.2.weight": p["input_prelu"]}
    for k in ("weight", "bias", "running_mean", "running_var"):
        state[f"input_layer.1.{k}"] = p["input_bn"][k]
        state[f"output_layer.0.{k}"] = p["output_bn"][k]
    for i, (in_c, depth, _) in enumerate(tarc.ir_se_50_layout()):
        bp = p["body"][f"{i}"]
        for k in ("weight", "bias", "running_mean", "running_var"):
            state[f"body.{i}.res_layer.0.{k}"] = bp["bn1"][k]
            state[f"body.{i}.res_layer.4.{k}"] = bp["bn2"][k]
        state[f"body.{i}.res_layer.1.weight"] = bp["conv1_weight"]
        state[f"body.{i}.res_layer.2.weight"] = bp["prelu"]
        state[f"body.{i}.res_layer.3.weight"] = bp["conv2_weight"]
        state[f"body.{i}.res_layer.5.fc1.weight"] = bp["se"]["fc1_weight"]
        state[f"body.{i}.res_layer.5.fc2.weight"] = bp["se"]["fc2_weight"]
        if in_c != depth:
            state[f"body.{i}.shortcut_layer.0.weight"] = \
                bp["shortcut_conv_weight"]
            for k in ("weight", "bias", "running_mean", "running_var"):
                state[f"body.{i}.shortcut_layer.1.{k}"] = bp["shortcut_bn"][k]
    state["output_layer.3.weight"] = p["output_linear"]["weight"]
    state["output_layer.3.bias"] = p["output_linear"]["bias"]
    state["output_layer.4.running_mean"] = p["output_bn1d"]["running_mean"]
    state["output_layer.4.running_var"] = p["output_bn1d"]["running_var"]
    return state


def write_arcface_pth(path, seed=0):
    """A model_ir_se50.pth-format file of random IR-SE-50 weights; returns
    the params it holds."""
    params = tarc.init_backbone_params(torch.Generator().manual_seed(seed),
                                       device="cpu")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in _arcface_state(params).items()}, path)
    return params


def test_load_arcface_reads_a_pth(tmp_path):
    path = str(tmp_path / "model_ir_se50.pth")
    params = write_arcface_pth(path)
    got = load_arcface(path, device="cpu")
    _trees_equal(params_to_numpy(got), params_to_numpy(params))
    from stylemc_tpu.io import load_state_dict_numpy as jax_state
    want = jarc.params_from_torch_state(jax_state(path))
    want["output_bn1d"] = {k: v for k, v in want["output_bn1d"].items()
                           if v is not None}
    _trees_equal(params_to_numpy(got),
                 jax.tree_util.tree_map(np.asarray, want))


def test_model_zoo_random_init_and_missing_weights(monkeypatch):
    for var in ("STYLEMC_CLIP_DIR", "STYLEMC_CLIP_BPE", "STYLEMC_ARCFACE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        load_arcface(device="cpu")
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        load_clip_models("small", device="cpu")
    a1 = load_arcface(allow_random_init=True, device="cpu")
    a2 = load_arcface(allow_random_init=True, device="cpu")
    _trees_equal(params_to_numpy(a1), params_to_numpy(a2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_arcface(allow_random_init=True)
