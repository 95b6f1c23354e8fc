"""The port's GAN evaluation against the JAX package's, on the CPU (fp32).

The same numpy features, weights (from the JAX initialisers, carried over
with `params_from_numpy`) and images go through both packages:

* FID, IS and FeatureStats on the same features: rtol 1e-6 (the same
  host numpy code); KID, P&R and the batched distances, torch products on
  a device (the CPU here), against JAX's numpy: KID 1e-6 at the default
  subsets and 1e-5 at others, the distances 1e-5, P&R equal;
* Inception v3: each block (A–E and E-last, both variants) at small
  planes 1e-5; the whole network at 299, batch 1, per variant 1e-4 (one
  JAX run per variant); the resize matrix and the torch-state converter
  exactly equal;
* LPIPS (alex, vgg, squeeze) features and `lpips_loss` at 64²: 1e-5; the
  converters exactly equal;
* `compute_ppl` and `calc_metric` (FID, KID, P&R, IS, PPL) on a tiny
  generator, both packages fed the same z and t: rtol 1e-4, PPL at ε 1e-2;
  at PPL's registered ε 1e-4 a pair's two renders differ by ~1e-4, so a
  pair's fp32 distance drifts by up to ~1e-2 in either package; there the
  port's fp32 mean over 1024 pairs is held within 1.5e-4 of JAX in
  float64 (styles interpolated and every block run in float64) and each of
  the first 16 pairs within 1e-2, with JAX's own fp32 run reading at least
  a third of each;
  `calculate_lec` on a tiny pSp: 1e-4; the registry's names equal;
* the port's calc_metrics CLI against its own library call.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu import metrics as jmetrics
from stylemc_tpu.losses import lpips as jlpips
from stylemc_tpu.metrics import inception as jinc
from stylemc_tpu.metrics import lec as jlec
from stylemc_tpu.metrics import ppl as jppl
from stylemc_tpu.metrics import scores as jscores
from stylemc_tpu.models import perceptual as jperc
from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_torch import metrics as tmetrics
from stylemc_torch.cli import calc_metrics as tcli
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.io import save_native
from stylemc_torch.losses import lpips as tlpips
from stylemc_torch.metrics import inception as tinc
from stylemc_torch.metrics import lec as tlec
from stylemc_torch.metrics import ppl as tppl
from stylemc_torch.metrics import scores as tscores
from stylemc_torch.models import perceptual as tperc
from stylemc_torch.models.stylegan2 import generator as tgen
from torch_threads import one_torch_thread  # noqa: F401

GEN_KW = dict(img_resolution=32, channel_base=512, channel_max=32,
              mapping_layers=2)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _trees_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# --------------------------------------------------------------------- scores


@pytest.fixture(scope="module")
def feats():
    return _rand(0, 300, 16), _rand(1, 260, 16) + 0.3


def test_scores_match_jax(feats):
    """FID, IS and KID at 1e-6 (FID and IS host numpy as in JAX; KID's
    float64 kernels a torch product on a device, the CPU here) and P&R
    equal, at the scores' default sizes; the distances and other subset
    sizes are test_device_products_match_numpy's."""
    real, gen = feats
    mu_r, sig_r = real.mean(0), np.cov(real.T, bias=True)
    mu_g, sig_g = gen.mean(0), np.cov(gen.T, bias=True)
    np.testing.assert_allclose(
        tscores.fid_from_stats(mu_g, sig_g, mu_r, sig_r),
        jscores.fid_from_stats(mu_g, sig_g, mu_r, sig_r), rtol=1e-6)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(gen) * 3, axis=-1))
    for splits in (4, 1000):
        np.testing.assert_allclose(
            tscores.inception_score_from_probs(probs, splits),
            jscores.inception_score_from_probs(probs, splits), rtol=1e-6)
    np.testing.assert_allclose(
        tscores.kid_from_features(real, gen, device="cpu"),
        jscores.kid_from_features(real, gen), rtol=1e-6)
    for shift in (0.0, 50.0):
        assert tscores.precision_recall_from_features(
            real, gen + shift, device="cpu") == \
            jscores.precision_recall_from_features(real, gen + shift)


def test_feature_stats_match_jax(feats):
    x = feats[0]
    got = tmetrics.FeatureStats(capture_all=True, capture_mean_cov=True,
                                max_items=250)
    want = jmetrics.FeatureStats(capture_all=True, capture_mean_cov=True,
                                 max_items=250)
    for lo in range(0, 300, 100):
        # the port also takes tensors (on any device)
        got.append(torch.from_numpy(x[lo:lo + 100]) if lo else x[lo:lo + 100])
        want.append(x[lo:lo + 100])
    assert got.num_items == want.num_items == 250 and got.is_full()
    np.testing.assert_array_equal(got.get_all(), want.get_all())
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    got.append_multihost(x)  # one process: append, here past max_items
    assert got.num_items == 250


def test_device_products_match_numpy(feats):
    """KID's kernels and P&R's distances as torch products on a device
    (the CPU here) against the numpy ones."""
    real, gen = feats
    d = tscores.compute_distances_batched(torch.from_numpy(real),
                                          torch.from_numpy(gen), 64)
    assert isinstance(d, torch.Tensor)
    _close(d, jscores.compute_distances_batched(real, gen, 64))
    for n_sub, size in ((10, 100), (3, 1000)):
        np.testing.assert_allclose(
            tscores.kid_from_features(real, gen, n_sub, size, device="cpu"),
            jscores.kid_from_features(real, gen, n_sub, size), rtol=1e-5)
    for shift in (0.0, 2.0, 50.0):
        assert tscores.precision_recall_from_features(
            real, gen + shift, 3, row_batch_size=128, col_batch_size=96,
            device="cpu") == jscores.precision_recall_from_features(
            real, gen + shift, 3, row_batch_size=128, col_batch_size=96)


# ------------------------------------------------------------------ inception


@pytest.fixture(scope="module")
def inception():
    jp = jinc.init_inception_params(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jp, "cpu")


BLOCKS = {"A": ("Mixed_5b", 192), "B": ("Mixed_6a", 288),
          "C": ("Mixed_6b", 768), "D": ("Mixed_7a", 768),
          "E": ("Mixed_7b", 1280), "E_last": ("Mixed_7c", 2048)}
BLOCK_FNS = {"A": "_inception_a", "B": "_inception_b", "C": "_inception_c",
             "D": "_inception_d", "E": "_inception_e",
             "E_last": "_inception_e_last"}


@pytest.mark.parametrize("variant", ["fid2015", "tv"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_inception_blocks_match_jax(inception, block, variant):
    jp, tp = inception
    name, cin = BLOCKS[block]
    # post-ReLU-like inputs on a 9x7 plane (odd, so the stride-2 blocks and
    # the count_include_pad border both show)
    x = np.abs(_rand(3, 1, cin, 9, 7))
    fid = variant == "fid2015"
    want = getattr(jinc, BLOCK_FNS[block])(jp[name], jnp.asarray(x), fid=fid)
    got = getattr(tinc, BLOCK_FNS[block])(tp[name], torch.from_numpy(x),
                                          fid=fid)
    _close(got, want)


def test_inception_pools_match_jax():
    x = _rand(4, 2, 3, 9, 9)
    for inc in (True, False):
        _close(tinc._avgpool3(torch.from_numpy(x), inc),
               jinc._avgpool3(jnp.asarray(x), inc), 1e-6, 1e-6)
    _close(tinc._maxpool3s1(torch.from_numpy(x)),
           jinc._maxpool3s1(jnp.asarray(x)), 0, 0)
    _close(tinc._maxpool(torch.from_numpy(x)), jinc._maxpool(jnp.asarray(x)),
           0, 0)


@pytest.mark.parametrize("variant", ["fid2015", "tv"])
def test_inception_features_match_jax(inception, variant):
    """The whole network at 299, batch 1: one JAX run per variant, its
    features also giving the probabilities through the fc."""
    jp, tp = inception
    img = np.random.RandomState(5).randint(0, 256, (1, 299, 299, 3), np.uint8)
    want = np.asarray(jax.jit(
        lambda p, x: jinc.inception_features(p, x, variant=variant))(
        jp, jnp.asarray(img)))
    with torch.no_grad():
        got = tinc.inception_features(tp, torch.from_numpy(img),
                                      variant=variant)
        probs = tinc.inception_features(tp, img, return_logits=True,
                                        variant=variant)
    assert got.shape == (1, 2048)
    _close(got, want, rtol=1e-4, atol_rel=1e-4)
    logits = want @ np.asarray(jp["fc"]["weight"]).T + \
        np.asarray(jp["fc"]["bias"])
    _close(probs, jax.nn.softmax(jnp.asarray(logits), axis=-1), rtol=1e-4,
           atol_rel=1e-4)


def test_inception_resize_and_converter_match_jax(inception, monkeypatch):
    jp, tp = inception
    for n_in in (32, 256, 299, 512):
        np.testing.assert_array_equal(tinc._resize_matrix_bilinear(n_in, 299),
                                      jinc._resize_matrix_bilinear(n_in, 299))
    # a non-299 input is resized by those matrices before the stem
    img = np.random.RandomState(6).randint(0, 256, (1, 40, 24, 3), np.uint8)
    x = img.astype(np.float32).transpose(0, 3, 1, 2)
    x = np.einsum("oh,nchw->ncow", jinc._resize_matrix_bilinear(40, 299), x)
    x = np.einsum("ow,nchw->ncho", jinc._resize_matrix_bilinear(24, 299), x)
    seen = []
    stem = tinc._basic
    monkeypatch.setattr(tinc, "_basic", lambda p, y, *a, **kw: seen.append(
        y.clone()) or stem(p, y, *a, **kw))
    with torch.no_grad():
        tinc.inception_features(tp, img)
    _close(seen[0], x / 127.5 - 1.0, 1e-6, 1e-6)
    # the torchvision state dict → the same tree in both packages
    state = {}
    for name, p in params_to_numpy(tp).items():
        if name == "fc":
            state.update({f"fc.{k}": v for k, v in p.items()})
            continue
        for blk, bp in ([(name, p)] if "conv_weight" in p else
                        [(f"{name}.{k}", v) for k, v in p.items()]):
            state[f"{blk}.conv.weight"] = bp["conv_weight"]
            state.update({f"{blk}.bn.{k}": v for k, v in bp["bn"].items()})
    _trees_equal(tinc.params_from_torch_state(state),
                 jinc.params_from_torch_state(state))
    no_fc = {k: v for k, v in state.items() if not k.startswith("fc.")}
    _trees_equal(tinc.params_from_torch_state(no_fc),
                 jinc.params_from_torch_state(no_fc))


def test_inception_init_layout_matches_jax(inception):
    jp, _ = inception
    tp = tinc.init_inception_params(torch.Generator().manual_seed(0),
                                    device="cpu")
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jp)
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), tp) == shapes


# ---------------------------------------------------------------------- LPIPS


@pytest.fixture(scope="module")
def lpips_nets():
    out = {}
    for i, net in enumerate(("alex", "vgg", "squeeze")):
        jp = jlpips.init_lpips_params(jax.random.PRNGKey(i), net)
        out[net] = (jp, params_from_numpy(jp, "cpu"))
    return out


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(lpips_nets, net):
    jp, tp = lpips_nets[net]
    x, y = (np.tanh(_rand(s, 2, 3, 64, 64)) for s in (7, 8))
    got = tperc.features(tp["backbone"], torch.from_numpy(x), net)
    want = jperc.features(jp["backbone"], jnp.asarray(x), net)
    assert len(got) == len(want) == len(tperc.lpips_channels(net))
    for a, b in zip(got, want):
        _close(a, b)
    _close(tlpips.lpips_loss(tp, torch.from_numpy(x), torch.from_numpy(y),
                             net),
           jlpips.lpips_loss(jp, jnp.asarray(x), jnp.asarray(y), net))
    assert tuple(tperc.lpips_channels(net)) == \
        tuple(jperc.lpips_channels(net))


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_converters_match_jax(lpips_nets, net):
    jp, tp = lpips_nets[net]
    state = {}
    for name, p in params_to_numpy(tp["backbone"]).items():
        for part, q in ([("", p)] if "weight" in p else
                        [(f".{k}", v) for k, v in p.items()]):
            state[f"{name}{part}.weight"] = q["weight"]
            state[f"{name}{part}.bias"] = q["bias"]
    lins = {f"{i}.1.weight": np.asarray(v["weight"])
            for i, v in sorted(jp["lin"].items())}
    _trees_equal(tperc.backbone_from_torch_state(state, net),
                 jperc.backbone_from_torch_state(state, net))
    _trees_equal(tlpips.lpips_params_from_torch(state, lins, net),
                 jlpips.lpips_params_from_torch(state, lins, net))
    _trees_equal(params_to_numpy(params_from_numpy(
        tlpips.lpips_params_from_torch(state, lins, net), "cpu")),
        params_to_numpy(tp))


# --------------------------------------------------------- PPL and calc_metric


@pytest.fixture(scope="module")
def gens():
    cfg = jgen.GeneratorConfig(**GEN_KW)
    gp = jgen.init_generator_params(jax.random.PRNGKey(0), cfg)
    return cfg, gp, tgen.GeneratorConfig(**GEN_KW), params_from_numpy(gp,
                                                                      "cpu")


def _jax_z(seed, n, batch, z_dim):
    """The z batches JAX's `_gen_images` draws."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(0, n, batch):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(k, (batch, z_dim))))
    return out


def _jax_ppl_pairs(seed, n, batch, z_dim, sampling="end"):
    """The (z0, z1, t) batches JAX's `compute_ppl` draws."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(0, n, batch):
        rng, k0, k1, kt = jax.random.split(rng, 4)
        t = jax.random.uniform(kt, (batch,)) if sampling == "full" else \
            jnp.zeros((batch,))
        out.append((np.asarray(jax.random.normal(k0, (batch, z_dim))),
                    np.asarray(jax.random.normal(k1, (batch, z_dim))),
                    np.asarray(t)))
    return out


def _ppl_pair(gens, lpips_nets, **kw):
    """compute_ppl on the tiny generator in both packages, the port fed
    JAX's pairs: (port, JAX)."""
    cfg, gp, tcfg, tgp = gens
    jl, tl = lpips_nets["vgg"]
    kw = {"num_samples": 8, "batch_size": 4, **kw}
    want = jppl.compute_ppl(
        lambda g, z: jgen.mapping(g, cfg, z),
        lambda g, w: jgen.synthesis(g, cfg, jgen.w_to_s(g, cfg, w)), jl,
        cfg.z_dim, gen_params=gp, **kw)
    got = tppl.compute_ppl(
        lambda g, z: tgen.mapping(g, tcfg, z),
        lambda g, w: tgen.synthesis(g, tcfg, tgen.w_to_s(g, tcfg, w)), tl,
        cfg.z_dim, gen_params=tgp, device="cpu",
        latents=_jax_ppl_pairs(0, kw["num_samples"], kw["batch_size"],
                               cfg.z_dim, kw.get("sampling", "end")), **kw)
    return got, want


def test_slerp_and_compute_ppl_match_jax(gens, lpips_nets):
    """At ε = 1e-2 (the images of a pair differ by ~1 %); ε = 1e-4 is held
    in the next test."""
    a, b = _rand(9, 4, 16), _rand(10, 4, 16)
    t = np.linspace(0, 1, 4, dtype=np.float32)[:, None]
    _close(tppl.slerp(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(t)),
           jppl.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    for kw in ({}, {"space": "z", "sampling": "full", "crop": True}):
        got, want = _ppl_pair(gens, lpips_nets, epsilon=1e-2, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-4)


PPL_EPS = 1e-4
PPL_PAIRS = 1024           # pairs in batches of 8; the first 16 as before
PPL_PAIR_RTOL_F64 = 1e-2   # each of the first 16 pairs' fp32 distance
PPL_MEAN_RTOL_F64 = 1.5e-4  # the mean over PPL_PAIRS pairs


def test_ppl_at_the_registered_epsilon_against_float64(gens, lpips_nets,
                                                       monkeypatch):
    """At ppl2_wend's ε = 1e-4 the two renders of a pair differ by ~1e-4,
    so fp32 rounding (~1e-7) of either render is ~1e-3 of their difference
    in either package. The distances compute_ppl takes the mean of are
    held against JAX in float64 on the same pairs: each of the first 16
    pairs within PPL_PAIR_RTOL_F64 and the mean over PPL_PAIRS pairs within
    PPL_MEAN_RTOL_F64, and JAX's own fp32 run of the same pairs must read
    at least a third of each bound, so that neither is slack above fp32's
    floor.

    The float64 side interpolates in S (w_to_s is affine, so s(w0 + ε(w1 -
    w0)) = s0 + ε(s1 - s0)) and runs every block in float64: w_to_s packs
    the styles into a float32 buffer and the default blocks run in float32,
    so a lerp in W rounds the pair's 1e-4 style difference to float32 and
    the reference would carry fp32 noise of its own (rms 2.5e-3 a pair, and
    correlated with JAX's fp32 run, which rounds the same way). The pairs'
    fp32 errors are then independent (rms ~2.4e-3 in either package), so
    the mean of n pairs carries ~2.4e-3 / sqrt(n): 7.5e-5 at 1024."""
    import dataclasses

    cfg, gp, tcfg, tgp = gens
    jl, tl = lpips_nets["vgg"]
    pairs = _jax_ppl_pairs(0, PPL_PAIRS, 8, cfg.z_dim)
    cfg64 = dataclasses.replace(cfg, low_precision_dtype="float64",
                                num_fp16_res=len(cfg.block_resolutions))

    def jax_f64(g, lp, z0, z1):
        s0, s1 = (jgen.w_to_s(g, cfg, jgen.mapping(g, cfg, z)).astype(
            jnp.float64) for z in (z0, z1))
        img0 = jgen.synthesis(g, cfg64, s0)
        img1 = jgen.synthesis(g, cfg64, s0 + (s1 - s0) * PPL_EPS)
        return jppl._lpips_distance_pairs(lp, img0, img1) / PPL_EPS ** 2

    def jax_fp32(g, lp, z0, z1):
        w0, w1 = jgen.mapping(g, cfg, z0), jgen.mapping(g, cfg, z1)
        img0 = jgen.synthesis(g, cfg, jgen.w_to_s(g, cfg, w0))
        img1 = jgen.synthesis(g, cfg, jgen.w_to_s(
            g, cfg, w0 + (w1 - w0) * PPL_EPS))
        return jppl._lpips_distance_pairs(lp, img0, img1) / PPL_EPS ** 2

    with jax.enable_x64(True):
        f64 = jax.jit(jax_f64)
        tree = jax.tree_util.tree_map(
            lambda v: jnp.asarray(np.asarray(v), jnp.float64), (gp, jl))
        want = np.concatenate([np.asarray(f64(*tree, jnp.asarray(
            z0, jnp.float64), jnp.asarray(z1, jnp.float64)))
            for z0, z1, _ in pairs])
    # JAX's own fp32 run of the same pairs: how far fp32 itself reads
    # from float64 at this ε
    f32 = jax.jit(jax_fp32)
    jax_got = np.concatenate([np.asarray(f32(gp, jl, jnp.asarray(z0),
                                             jnp.asarray(z1)))
                              for z0, z1, _ in pairs])
    # the port's distances, as compute_ppl computes them
    dists = []

    def recorded(*args):
        dists.append(tlpips.lpips_distances(*args).numpy())
        return torch.from_numpy(dists[-1])

    monkeypatch.setattr(tppl, "lpips_distances", recorded)
    tppl.compute_ppl(
        lambda g, z: tgen.mapping(g, tcfg, z),
        lambda g, w: tgen.synthesis(g, tcfg, tgen.w_to_s(g, tcfg, w)), tl,
        cfg.z_dim, num_samples=PPL_PAIRS, batch_size=8, gen_params=tgp,
        latents=pairs, epsilon=PPL_EPS, device="cpu")
    got = np.concatenate(dists) / PPL_EPS ** 2

    def reading(v):
        return (np.abs(v[:16] / want[:16] - 1).max(),
                abs(v.mean() / want.mean() - 1))

    port_pair, port_mean = reading(got)
    jax_pair, jax_mean = reading(jax_got)
    print(f"PPL at eps {PPL_EPS} against float64 (max of the first 16 "
          f"pairs, mean of {PPL_PAIRS}): port fp32 {port_pair:.4g}, "
          f"{port_mean:.4g}; JAX fp32 {jax_pair:.4g}, {jax_mean:.4g}")
    assert port_pair <= PPL_PAIR_RTOL_F64
    assert port_mean <= PPL_MEAN_RTOL_F64
    # the bounds sit at fp32's own floor: JAX in fp32 reads at least a
    # third of each from float64 on the same pairs
    assert jax_pair >= PPL_PAIR_RTOL_F64 / 3
    assert jax_mean >= PPL_MEAN_RTOL_F64 / 3


@pytest.fixture(scope="module")
def metric_opts(gens, lpips_nets):
    """Both packages' MetricOptions on the tiny generator: a linear
    16-feature detector, 64 dataset features, 32 generated images in
    batches of 16, the same z and t streams."""
    cfg, gp, tcfg, tgp = gens
    proj = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (32 * 32 * 3, 16)) * 0.02)

    def dataset(stats_cls, fn):
        def features(opts, max_items):
            stats = stats_cls(capture_all=True, capture_mean_cov=True,
                              max_items=64)
            rng = np.random.RandomState(0)
            while not stats.is_full():
                stats.append(fn(rng.randint(0, 255, (16, 32, 32, 3),
                                            np.uint8)))
            return stats
        return features

    def jfeat(imgs):
        x = jnp.asarray(imgs, jnp.float32).reshape(imgs.shape[0], -1)
        return np.asarray(x @ proj)

    tproj = torch.from_numpy(np.array(proj))

    def tfeat(imgs):
        x = torch.as_tensor(imgs).float().reshape(imgs.shape[0], -1)
        return x @ tproj

    jo = jmetrics.MetricOptions(
        gen_params=gp, gen_cfg=cfg, inception_features_fn=jfeat,
        inception_probs_fn=lambda i: np.asarray(
            jax.nn.softmax(jnp.asarray(jfeat(i)), axis=-1)),
        dataset_features_fn=dataset(jmetrics.FeatureStats, jfeat),
        lpips_params=lpips_nets["vgg"][0], num_gen=32, batch_size=16)
    to = tmetrics.MetricOptions(
        gen_params=tgp, gen_cfg=tcfg, inception_features_fn=tfeat,
        inception_probs_fn=lambda i: torch.softmax(tfeat(i), dim=-1),
        dataset_features_fn=dataset(tmetrics.FeatureStats, tfeat),
        lpips_params=lpips_nets["vgg"][1], num_gen=32, batch_size=16,
        device="cpu",
        z_batches=lambda: iter(_jax_z(0, 32, 16, cfg.z_dim)),
        ppl_batches=lambda: iter(_jax_ppl_pairs(0, 32, 16, cfg.z_dim)))
    return jo, to


@pytest.mark.parametrize("metric", ["fid50k_full", "kid50k_full",
                                    "pr50k3_full", "is50k", "ppl2_wend"])
def test_calc_metric_matches_jax(metric_opts, metric, monkeypatch):
    """ppl2_wend runs its ε = 1e-4 through both packages' compute_ppl at
    1e-2, where fp32 holds rtol 1e-4 (the registered ε is held against
    float64 above)."""
    jo, to = metric_opts
    for mod in (jppl, tppl):
        def at_1e2(*a, _fn=mod.compute_ppl, **kw):
            assert kw.pop("epsilon") == PPL_EPS
            return _fn(*a, epsilon=1e-2, **kw)
        monkeypatch.setattr(mod, "compute_ppl", at_1e2)
    want = jmetrics.calc_metric(metric, opts=jo)
    got = tmetrics.calc_metric(metric, opts=to)
    assert got.metric == metric and sorted(got.results) == \
        sorted(want.results)
    for k, v in want.results.items():
        assert np.isfinite(got.results[k])
        np.testing.assert_allclose(got.results[k], v, rtol=1e-4)
    assert got.total_time >= 0 and got.total_time_str.endswith("s")


def test_registry_names_match_jax():
    assert tmetrics.list_valid_metrics() == jmetrics.list_valid_metrics()
    for name in ("fid50k_full", "kid50k_full", "pr50k3_full", "ppl2_wend",
                 "is50k", "fid50k", "kid50k", "pr50k3"):
        assert tmetrics.is_valid_metric(name)
    assert not tmetrics.is_valid_metric("nope")


# ------------------------------------------------------------------------ LEC


def test_calculate_lec_matches_jax():
    """On a tiny pSp (stylegan_size 32, the tiny e4e body) with the same
    weights, a shift edit and its inverse."""
    from stylemc_tpu.models.e4e import psp as jpsp
    from stylemc_torch.models.e4e import encoders, psp
    from tiny import TINY_E4E_LAYOUT

    gkw = dict(img_resolution=32, channel_base=1024, channel_max=64,
               mapping_layers=2, conv_clamp=None, num_fp16_res=0)
    enc = encoders.init_encoder_params(torch.Generator().manual_seed(1), 32,
                                       layout=TINY_E4E_LAYOUT, device="cpu")
    dec = tgen.init_generator_params(torch.Generator().manual_seed(2),
                                     tgen.GeneratorConfig(**gkw),
                                     device="cpu")
    la = _rand(4, 8, 512, scale=0.1)
    tp = psp.PSP(psp.PSPConfig(32, encoder_layout=TINY_E4E_LAYOUT), enc,
                 tgen.GeneratorConfig(**gkw), dec, torch.from_numpy(la))
    jp = jpsp.PSP(jpsp.PSPConfig(32, encoder_layout=TINY_E4E_LAYOUT),
                  params_to_numpy(enc), jgen.GeneratorConfig(**gkw),
                  params_to_numpy(dec), la)
    batches = [_rand(20 + i, 1, 3, 256, 256, scale=0.2) for i in range(3)]
    want = jlec.calculate_lec(jp, iter(batches), lambda w: w + 0.05,
                              lambda w: w - 0.05, n_batches=3)
    got = tlec.calculate_lec(tp, iter((b, None) for b in batches),
                             lambda w: w + 0.05, lambda w: w - 0.05,
                             n_batches=3)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    d = np.asarray([5.0, 1.0, 3.0, 100.0, 2.0])
    np.testing.assert_array_equal(tlec._filter_outliers(d),
                                  jlec._filter_outliers(d))


# ------------------------------------------------------------------------ CLI


def test_calc_metrics_cli_matches_its_library_call(gens, tmp_path,
                                                   monkeypatch):
    """The CLI with seeded detectors (--allow_random_init) prints one JSON
    line per metric, equal to calc_metric with the same detectors and the
    same generator on the same device."""
    _, _, tcfg, tgp = gens
    net = str(tmp_path / "net.npz")
    save_native(net, tcfg, tgp)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(11)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (32, 32, 3), np.uint8)).save(
            data / f"{i}.png")
    monkeypatch.delenv("STYLEMC_INCEPTION", raising=False)
    monkeypatch.delenv("STYLEMC_LPIPS_VGG", raising=False)
    names = ["kid50k_full", "is50k", "ppl2_wend"]
    r = CliRunner().invoke(tcli.main, [
        "--network", net, "--metrics", ",".join(names), "--data", str(data),
        "--num_gen", "2", "--batch", "2", "--allow_random_init",
        "--detector_variant", "tv", "--device", "cpu"],
        catch_exceptions=False)
    assert r.exit_code == 0, r.output
    lines = [json.loads(x) for x in r.output.splitlines()
             if x.startswith("{")]
    assert [x["metric"] for x in lines] == names

    inc = tinc.init_inception_params(
        torch.Generator().manual_seed(tcli.INCEPTION_SEED), device="cpu")

    def features_fn(x):
        return tinc.inception_features(inc, x, variant="tv")

    def dataset_features_fn(opts, max_items):
        stats = tmetrics.FeatureStats(capture_all=True, capture_mean_cov=True,
                                      max_items=max_items)
        stats.append(features_fn(torch.from_numpy(np.stack([
            np.asarray(Image.open(data / f"{i}.png")) for i in range(2)]))))
        return stats

    opts = tmetrics.MetricOptions(
        gen_params=tgp, gen_cfg=tcfg,
        inception_features_fn=features_fn,
        inception_probs_fn=lambda x: tinc.inception_features(
            inc, x, return_logits=True, variant="tv"),
        dataset_features_fn=dataset_features_fn,
        lpips_params=tlpips.init_lpips_params(
            torch.Generator().manual_seed(tcli.LPIPS_SEED), "vgg",
            device="cpu"), num_gen=2, batch_size=2, device="cpu")
    for line in lines:
        want = tmetrics.calc_metric(line["metric"], opts=opts).results
        assert line["detector"] == "tv"
        for k, v in want.items():
            assert line[k] == v, (k, line[k], v)
    # an unknown name is refused before anything is loaded, and so is a
    # dataset metric without --data
    r = CliRunner().invoke(tcli.main, ["--network", "missing.npz",
                                       "--metrics", "nope", "--device",
                                       "cpu"])
    assert r.exit_code == 2 and "unknown metric nope" in r.output
    r = CliRunner().invoke(tcli.main, [
        "--network", net, "--metrics", "kid50k_full", "--num_gen", "2",
        "--batch", "2", "--allow_random_init", "--device", "cpu"])
    assert r.exit_code == 2 and "--data is required" in r.output


def test_lpips_pickle_reads_numpy_trees_only(lpips_nets, tmp_path):
    """STYLEMC_LPIPS_VGG's file: a pickled tree of numpy arrays loads as
    it was written; a pickle that would call anything else is refused."""
    import os
    import pickle

    tree = params_to_numpy(lpips_nets["vgg"][1])
    path = tmp_path / "lpips_vgg.pkl"
    path.write_bytes(pickle.dumps(tree))
    _trees_equal(tcli.load_lpips_pickle(str(path)), tree)
    path.write_bytes(pickle.dumps({"backbone": os.getcwd}))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        tcli.load_lpips_pickle(str(path))
