"""The port's e4e trainer against the JAX package's, on the CPU.

The same numpy weights (drawn by the port's seeded initialisers; the tiny
ArcFace from `tests/tiny.py`) and the same numpy batches go through both
packages' pieces, at `tests/test_coach.py`'s tiny config: a 256 px
generator (channel_base 512, channel_max 32, 2 mapping layers, no conv
clamp), `TINY_E4E_LAYOUT`, the tiny ArcFace, LPIPS-alex, batch 2.

* Ranger against optax over 14 steps (the SMA threshold switch, lookahead
  syncs at 6 and 12), with and without weight decay and gradient clipping:
  params rtol 1e-6; Adam against optax.adam: 1e-7;
* w_norm_loss 1e-6; moco_loss (through ResNet-50, in float64 on both
  sides, and the port's fp32 value against JAX's float64) and e4e_id_loss:
  the values (differences of unit cosines) within 1e-5, the gradients
  with respect to y_hat 1e-5; discriminator_apply 1e-6; the ResNet-50 and
  discriminator converters exact; LatentCodesPool under the same
  `random.seed` equal;
* the coach's loss at stages 0, 5 and 18 with the discriminator on: each
  loss 1e-5, y_hat 1e-5, each encoder gradient relative L2 1e-4; the
  discriminator step without and with R1: losses 1e-5, each param leaf
  relative L2 1e-5;
* train_step over 3 steps (default path and use_w_pool): key sets equal,
  each loss rtol 1e-4, the encoder after the run relative L2 1e-4; one
  train_decoder step: the decoder's and the encoder's gradients relative
  L2 1e-4, the port's step −lr times the centralised gradient; validate against the JAX loss's
  mean 1e-5;
* in the port alone: fuse_d_step True and False equal; save after 2 steps,
  load into a fresh coach and take 2 more equal to 4 straight steps, with
  the pickle and the directory backends.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylemc_tpu.losses import moco as jmoco
from stylemc_tpu.losses import w_norm as jwnorm
from stylemc_tpu.models import resnet as jresnet
from stylemc_tpu.models.e4e import discriminator as jdisc
from stylemc_tpu.models.e4e import psp as jpsp
from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_tpu.train import coach as jcoach
from stylemc_tpu.train.ranger import ranger as jax_ranger
from stylemc_torch.convert import params_from_numpy, params_to_numpy
from stylemc_torch.losses import lpips as tlpips
from stylemc_torch.losses import moco as tmoco
from stylemc_torch.losses import w_norm as twnorm
from stylemc_torch.models import resnet as tresnet
from stylemc_torch.models.e4e import discriminator as tdisc
from stylemc_torch.models.e4e import encoders as tenc
from stylemc_torch.models.e4e import psp as tpsp
from stylemc_torch.models.stylegan2 import generator as tgen
from stylemc_torch.train import coach as tcoach
from stylemc_torch.train import ranger as tranger
from tiny import TINY_ARCFACE_LAYOUT, TINY_E4E_LAYOUT, tiny_arcface
from torch_threads import one_torch_thread  # noqa: F401

GEN_KW = dict(img_resolution=256, channel_base=512, channel_max=32,
              mapping_layers=2, conv_clamp=None)
COACH_KW = dict(batch_size=2, stylegan_size=256, w_discriminator_lambda=0.1,
                id_lambda=0.1, lpips_lambda=0.8, l2_lambda=1.0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def _rel_l2(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        out.update(_paths(v, p) if isinstance(v, dict) else {p: v})
    return out


# ---------------------------------------------------------------- weights


@pytest.fixture(scope="module")
def weights():
    """One set of numpy weights for both packages."""
    cfg = tgen.GeneratorConfig(**GEN_KW)
    gen = params_to_numpy(tgen.init_generator_params(_gen(0), cfg,
                                                     device="cpu"))
    enc = params_to_numpy(tenc.init_encoder_params(
        _gen(1), 256, layout=TINY_E4E_LAYOUT, device="cpu"))
    lpips = params_to_numpy(tlpips.init_lpips_params(_gen(2), "alex",
                                                     device="cpu"))
    disc = params_to_numpy(tdisc.init_discriminator_params(_gen(3),
                                                           device="cpu"))
    arc = jax.tree_util.tree_map(np.asarray, tiny_arcface())
    latent_avg = _rand(4, 14, 512, scale=0.1)
    return {"gen": gen, "enc": enc, "lpips": lpips, "disc": disc,
            "arcface": arc, "latent_avg": latent_avg}


def make_coaches(w, jax_side=True, train_iter=None, test_iter=None, **kw):
    """(JAX coach, port coach) from the same weights and options; the JAX
    coach's discriminator takes the port's seeded weights."""
    opts = dict(COACH_KW, **kw)
    tc = tcoach.Coach(
        tcoach.CoachOptions(**opts),
        tpsp.PSP(cfg=tpsp.PSPConfig(256, encoder_layout=TINY_E4E_LAYOUT),
                 encoder_params=params_from_numpy(w["enc"], "cpu"),
                 decoder_cfg=tgen.GeneratorConfig(**GEN_KW),
                 decoder_params=params_from_numpy(w["gen"], "cpu"),
                 latent_avg=torch.from_numpy(w["latent_avg"])),
        {"lpips": w["lpips"], "arcface": w["arcface"]},
        train_iter or (lambda: None), test_iter,
        arcface_layout=TINY_ARCFACE_LAYOUT, device="cpu")
    if tc.discriminator_params is not None:
        with torch.no_grad():
            for p, v in zip(tranger.tree_leaves(tc.discriminator_params),
                            tranger.tree_leaves(params_from_numpy(
                                w["disc"], "cpu"))):
                p.copy_(v)
    if not jax_side:
        return None, tc
    tree = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
    jc = jcoach.Coach(
        jcoach.CoachOptions(**opts),
        jpsp.PSP(cfg=jpsp.PSPConfig(256, encoder_layout=TINY_E4E_LAYOUT),
                 encoder_params=tree(w["enc"]),
                 decoder_cfg=jgen.GeneratorConfig(**GEN_KW),
                 decoder_params=tree(w["gen"]),
                 latent_avg=jnp.asarray(w["latent_avg"])),
        {"lpips": tree(w["lpips"]), "arcface": tree(w["arcface"])},
        train_iter or (lambda: None), test_iter,
        arcface_layout=TINY_ARCFACE_LAYOUT)
    if jc.discriminator_params is not None:
        jc.discriminator_params = tree(w["disc"])
        jc.d_opt_state = jc.d_optimizer.init(jc.discriminator_params)
    return jc, tc


def batches(seed, n=3):
    return [_rand(seed + i, 2, 3, 256, 256, scale=0.3) for i in range(n)]


# ----------------------------------------------------------------- ranger


def _opt_tree(seed):
    rs = np.random.RandomState(seed)
    return {"b": rs.randn(7).astype(np.float32),
            "w": {"m": rs.randn(5, 6).astype(np.float32),
                  "c": rs.randn(4, 3, 3, 3).astype(np.float32)}}


@pytest.mark.parametrize("kw,clip", [({}, 0.0), ({"weight_decay": 1e-2}, 0.0),
                                     ({}, 2.0)],
                         ids=["plain", "weight_decay", "grad_clip"])
def test_ranger_matches_optax(kw, clip):
    """14 steps at the coach's learning rate: RAdam's SMA crosses its
    threshold at step 6 and lookahead syncs at steps 6 and 12. ρ_t is a
    difference of two ~2000-sized float32 terms, so XLA's and torch's
    float32 β2^t, one ulp apart, move the rectification r_t by up to 0.6 %
    (ROADMAP §C.3): at 1e-4 that is ≤ 2e-8 of a step."""
    lr = 1e-4
    jopt = jax_ranger(lr, **kw)
    if clip:
        jopt = optax.chain(optax.clip_by_global_norm(clip), jopt)
    topt = tranger.ranger(lr, **kw)
    if clip:
        topt = tranger.chain(tranger.clip_by_global_norm(clip), topt)
    jp = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    tp = params_from_numpy(_opt_tree(0), "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(14):
        g = _opt_tree(100 + step)
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        u, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp)
        tranger.apply_updates(tp, u)
        got = _paths(tp)
        for k, want in _paths(jax.device_get(jp)).items():
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{step} {k}")


def test_adam_matches_optax():
    """The discriminator's (and optim_name='adam''s) torch Adam against
    optax.adam at the discriminator's learning rate."""
    lr = 2e-5
    jp = jax.tree_util.tree_map(jnp.asarray, _opt_tree(0))
    tp = params_from_numpy(_opt_tree(0), "cpu")
    jopt = optax.adam(lr)
    js = jopt.init(jp)
    topt = tcoach._AdamStep(tp, lr)
    for step in range(5):
        g = _opt_tree(200 + step)
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        topt.step(tp, params_from_numpy(g, "cpu"))
    got = _paths(tp)
    for k, want in _paths(jax.device_get(jp)).items():
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-7, atol=1e-7)


# ----------------------------------------------------------------- losses


def test_w_norm_loss_matches_jax():
    lat, avg = _rand(5, 3, 14, 512), _rand(6, 14, 512)
    for kw in ({}, {"start_from_latent_avg": False}):
        _close(twnorm.w_norm_loss(torch.from_numpy(lat),
                                  torch.from_numpy(avg), **kw),
               jwnorm.w_norm_loss(jnp.asarray(lat), jnp.asarray(avg), **kw),
               rtol=1e-6, atol_rel=0)
    _close(twnorm.w_norm_loss(torch.from_numpy(lat)),
           jwnorm.w_norm_loss(jnp.asarray(lat)), rtol=1e-6, atol_rel=0)


def _three_way(jfn, tfn, jp, tp, size, seed, dtype=np.float32, **kw):
    """A loss and its gradient to y_hat through both packages, in
    `dtype` (the JAX side inside jax.enable_x64 for float64)."""
    x, y, yh = (_rand(seed + i, 1, 3, size, size, scale=0.5).astype(dtype)
                for i in range(3))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                                jp)
    (jl, jsim), jg = jax.jit(jax.value_and_grad(
        lambda p, a, b, c: jfn(p, a, b, c, **kw), argnums=1,
        has_aux=True))(jp, jnp.asarray(yh), jnp.asarray(y), jnp.asarray(x))
    assert jg.dtype == dtype
    tp = tranger.tree_map(lambda t: t.to(getattr(torch, np.dtype(dtype)
                                                 .name)), tp)
    t = torch.from_numpy(yh).requires_grad_(True)
    tl, tsim = tfn(tp, t, torch.from_numpy(y), torch.from_numpy(x), **kw)
    tg, = torch.autograd.grad(tl, t)
    # the loss and the similarity gain are differences of unit cosines:
    # held to 1e-5 of that unit
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsim.item(), float(jsim), rtol=0, atol=1e-5)
    _close(tg, jg)
    return (x, y, yh), (float(jl), float(jsim))


def test_moco_loss_and_resnet50_match_jax():
    """MoCo's ResNet-50 at full width (seeded), at 224² and through the
    bicubic resize; its torchvision-name converter exact. A seeded
    ResNet-50 maps every input to nearly the same direction (cosines
    ~0.9998), so 1 − cos and its gradient cancel ~5000-fold and fp32's
    1e-6 noise in the features leaves ~1e-2 of the gradient: the features
    are held in float64 on both sides, and the port's fp32 loss against
    JAX's float64 one."""
    tp = tresnet.init_resnet50_params(_gen(7), device="cpu")
    npp = params_to_numpy(tp)
    with jax.enable_x64(True):
        inputs, (jl, jsim) = _three_way(jmoco.moco_loss, tmoco.moco_loss,
                                        npp, tp, 64, 9, dtype=np.float64)
    tl, tsim = tmoco.moco_loss(tp, *(torch.from_numpy(a.astype(np.float32))
                                     for a in inputs[::-1]))
    np.testing.assert_allclose(tl.item(), jl, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsim.item(), jsim, rtol=0, atol=1e-5)

    state = {}
    for path, v in _paths(npp).items():
        name = path[1:].replace("/", ".").replace("_weight", ".weight")
        state[name] = v
    got = tresnet.resnet50_from_torch_state(state)
    want = jax.device_get(jresnet.resnet50_from_torch_state(state))
    assert _paths(got).keys() == _paths(want).keys() == _paths(npp).keys()
    for k, v in _paths(want).items():
        np.testing.assert_array_equal(_paths(got)[k], v)
        np.testing.assert_array_equal(_paths(npp)[k], v)


def test_e4e_id_loss_matches_jax(weights):
    arc = weights["arcface"]
    _three_way(jmoco.e4e_id_loss, tmoco.e4e_id_loss, arc,
               params_from_numpy(arc, "cpu"), 256, 12,
               layout=TINY_ARCFACE_LAYOUT)


def test_discriminator_matches_jax(weights):
    d = weights["disc"]
    w = _rand(13, 4, 512)
    _close(tdisc.discriminator_apply(params_from_numpy(d, "cpu"),
                                     torch.from_numpy(w)),
           jdisc.discriminator_apply(jax.tree_util.tree_map(jnp.asarray, d),
                                     jnp.asarray(w)), rtol=1e-6, atol_rel=1e-6)
    # the converters carry the tree both ways unchanged
    back = params_to_numpy(params_from_numpy(d, "cpu"))
    assert _paths(back).keys() == _paths(d).keys()
    for k, v in _paths(d).items():
        np.testing.assert_array_equal(_paths(back)[k], v)
    # the same shapes and bounds as the JAX initialiser
    jd = jdisc.init_discriminator_params(jax.random.PRNGKey(0))
    for k, v in _paths(jax.device_get(jd)).items():
        got = _paths(d)[k]
        assert got.shape == v.shape
        assert np.abs(got).max() <= 1 / np.sqrt(512)


def test_latent_codes_pool_matches_jax():
    """Past pool_size the pool swaps codes at random: the same
    `random.seed` gives the same codes, for 2-D and 3-D queries."""
    queries = [_rand(20 + i, 4, 512) if i % 2 else _rand(20 + i, 4, 14, 512)
               for i in range(5)]
    out = {}
    for name, pool in (("jax", jdisc.LatentCodesPool(6)),
                       ("torch", tdisc.LatentCodesPool(6))):
        random.seed(3)
        out[name] = [pool.query(q) for q in queries]
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(b, a)
    random.seed(3)
    got = tdisc.LatentCodesPool(6).query(torch.from_numpy(queries[0]))
    np.testing.assert_array_equal(got, out["jax"][0])


# ------------------------------------------------------------------ coach


@pytest.fixture(scope="module")
def xy():
    x = _rand(30, 2, 3, 256, 256, scale=0.3)
    y = _rand(31, 2, 3, 256, 256, scale=0.3)
    return x, y


def _test_iter(seed):
    rs = np.random.RandomState(seed)

    def next_batch():
        x = (rs.randn(2, 3, 256, 256) * 0.3).astype(np.float32)
        return x, x.copy()
    return next_batch


@pytest.mark.parametrize("stage", [0, 5, 18])
def test_calc_loss_matches_jax(weights, xy, stage):
    """The loss, y_hat and the encoder's gradients; at stage 5 also
    validate() over two batches against the JAX loss's mean."""
    kw = {} if stage == 18 else dict(progressive_start=1,
                                     progressive_step_every=1)
    jc, tc = make_coaches(weights, **kw)
    jc.global_step = tc.global_step = 0 if stage == 18 else stage
    assert tc.progressive_stage() == jc.progressive_stage() == stage
    x, y = xy
    fn = jax.jit(jax.value_and_grad(
        lambda tr, xx, yy, dp: jc._calc_loss(tr, xx, yy, stage, dp),
        has_aux=True))
    (_, (jd, jy, _)), jg = fn(jc._trainable(), jnp.asarray(x),
                              jnp.asarray(y), jc.discriminator_params)
    tr = tc._trainable()
    loss, (td, ty, _) = tc._calc_loss(tr, torch.from_numpy(x),
                                      torch.from_numpy(y), stage,
                                      tc.discriminator_params)
    grads = iter(torch.autograd.grad(loss, tranger.tree_leaves(tr),
                                     allow_unused=True,
                                     materialize_grads=True))
    tg = _paths(tranger.tree_map(lambda _: next(grads), tr))
    assert sorted(td) == sorted(jd)
    assert ("total_delta_loss" in td) == (stage != 18)
    for k in jd:
        _close(td[k], jd[k], atol_rel=0)
    _close(ty, jy)
    jleaves = _paths(jax.device_get(jg))
    assert jleaves.keys() == tg.keys()
    for k, want in jleaves.items():
        assert _rel_l2(tg[k], want) <= 1e-4, k
    if stage != 5:
        return
    tc.test_iter, jit_iter = _test_iter(70), _test_iter(70)
    want = {}
    for _ in range(2):
        bx, by = jit_iter()
        (_, (d, _, _)), _ = fn(jc._trainable(), jnp.asarray(bx),
                               jnp.asarray(by), jc.discriminator_params)
        for k, v in d.items():
            want.setdefault(k, []).append(float(v))
    got = tc.validate(n_batches=2)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.mean(v), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("regularize", [False, True], ids=["plain", "r1"])
def test_discriminator_step_matches_jax(weights, regularize):
    jc, tc = make_coaches(weights, progressive_start=1,
                          progressive_step_every=1)
    real, fake = _rand(40, 2, 512), _rand(41, 2, 512, scale=0.5)
    # the step donates its inputs: keep them for the float64 run
    start = jax.tree_util.tree_map(np.array, (jc.discriminator_params,
                                              jc.d_opt_state))
    jdp, _, jout = jc._get_d_step_fn(regularize)(
        jc.discriminator_params, jc.d_opt_state, jnp.asarray(real),
        jnp.asarray(fake))
    tout = tc._d_step(torch.from_numpy(real), torch.from_numpy(fake),
                      regularize)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        _close(tout[k], jout[k], atol_rel=0)
    # per leaf, relative L2: Adam's first steps are ~lr·g/(|g| + eps), so
    # an element whose gradient is ~eps carries its gradient's fp32 noise
    # (the biases read ~7e-6 from float64 in either package). Each side is
    # held against JAX's step in float64 on the same start, and JAX's own
    # fp32 must read at least a third of the bound on some leaf, so that
    # the bound is not slack above that floor.
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if np.issubdtype(a.dtype, np.floating) else jnp.asarray(a),
            start)
        want = {k: np.asarray(v) for k, v in _paths(jax.device_get(
            jc._get_d_step_fn(regularize)(
                *f64, jnp.asarray(real, jnp.float64),
                jnp.asarray(fake, jnp.float64))[0])).items()}
    got = _paths(tc.discriminator_params)
    jax32 = _paths(jax.device_get(jdp))
    assert sorted(got) == sorted(want) == sorted(jax32)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-5, k
        assert _rel_l2(jax32[k], want[k]) <= 1e-5, k
    assert max(_rel_l2(jax32[k], want[k]) for k in want) >= 1e-5 / 3


def _run_steps(coach, xs, ys=None):
    return [coach.train_step(x, (ys or xs)[i].copy())
            for i, x in enumerate(xs)]


@pytest.mark.parametrize("pool", [False, True], ids=["default", "w_pool"])
def test_train_step_matches_jax(weights, pool):
    """3 steps, progressive stages 0, 1, 2, R1 at steps 0 and 2; with the
    W pool (the JAX package's unfused path) the pool draws from the same
    `random` stream on both sides."""
    kw = dict(progressive_start=1, progressive_step_every=1, d_reg_every=2,
              use_w_pool=pool, w_pool_size=3)
    jc, tc = make_coaches(weights, **kw)
    xs = batches(50)
    random.seed(4)
    jd = _run_steps(jc, xs)
    random.seed(4)
    td = _run_steps(tc, xs)
    for i, (a, b) in enumerate(zip(jd, td)):
        assert list(b) == list(a), i
        assert ("discriminator_r1_loss" in b) == (i % 2 == 0)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    want = _paths(jax.device_get(jc.psp.encoder_params))
    got = _paths(tc.psp.encoder_params)
    assert _rel_l2(np.concatenate([got[k].detach().numpy().ravel()
                                   for k in want]),
                   np.concatenate([v.ravel() for v in want.values()])) <= 1e-4


def test_train_decoder_step_matches_jax(weights):
    """One train_decoder step. Its gradients (encoder and decoder, each
    concatenated) against JAX's: relative L2 1e-4. The decoder's params
    after it are not a usable reading: a ~1e-5 update added to weights of
    magnitude 1-4 is rounded to their float32 ulp (1e-7 to 5e-7), and the
    two packages' sums round across different ulps often enough to read
    2.2e-4 on the update. So the port's step is held to its own gradient
    instead: Ranger's first update is −lr times the centralised gradient."""
    jc, tc = make_coaches(weights, train_decoder=True,
                          w_discriminator_lambda=0.0)
    x = batches(60, 1)[0]
    fn = jax.jit(jax.grad(lambda tr, xx: jc._calc_loss(tr, xx, xx, 18,
                                                       None)[0]))
    jg = _paths(jax.device_get(fn(jc._trainable(), jnp.asarray(x))))
    _, tg = tc.encoder_gradients(torch.from_numpy(x), torch.from_numpy(x), 18)
    tg = _paths(tg)
    assert tg.keys() == jg.keys()
    for part in ("/encoder/", "/decoder/"):
        keys = [k for k in jg if k.startswith(part)]
        assert _rel_l2(np.concatenate([tg[k].numpy().ravel() for k in keys]),
                       np.concatenate([np.asarray(jg[k]).ravel()
                                       for k in keys])) <= 1e-4, part
    tc.train_step(x, x.copy())
    lr = tc.opts.learning_rate
    for k, b in _paths(weights["gen"]).items():
        g = tg["/decoder" + k]
        if g.ndim > 1:
            g = g - g.mean(dim=tuple(range(1, g.ndim)), keepdim=True)
        want = torch.from_numpy(b).reshape(g.shape) - lr * g
        got = _paths(tc.psp.decoder_params)[k].detach()
        torch.testing.assert_close(got.reshape(g.shape), want, rtol=1e-6,
                                   atol=1e-7)


def _port_state(coach):
    return ([p.detach().clone() for p in
             tranger.tree_leaves(coach._trainable())],
            [p.detach().clone() for p in
             tranger.tree_leaves(coach.discriminator_params)])


def _assert_same(a, b):
    for ta, tb in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(ta, tb)


def test_fuse_d_step_is_the_same_sequence(weights):
    """fuse_d_step True and False take the same operations in the port:
    equal losses and params, the R1 key only on R1 steps when fetched."""
    kw = dict(progressive_start=1, progressive_step_every=1, d_reg_every=2)
    _, fused = make_coaches(weights, jax_side=False, **kw)
    _, unfused = make_coaches(weights, jax_side=False, fuse_d_step=False, **kw)
    xs = batches(80)
    for i, (a, b) in enumerate(zip(_run_steps(fused, xs),
                                   _run_steps(unfused, xs))):
        assert a == b, i
        assert ("discriminator_r1_loss" in a) == (i % 2 == 0)
    _assert_same(_port_state(fused), _port_state(unfused))
    # unfetched, the fused path keeps JAX's 0.0 entry on other steps
    d = fused.train_step(xs[0], xs[0].copy(), fetch=False)
    assert float(d["discriminator_r1_loss"]) == 0.0
    assert all(isinstance(v, torch.Tensor) for v in d.values())


CKPT_KW = dict(progressive_start=1, progressive_step_every=1, d_reg_every=3,
               optim_name="ranger")


@pytest.fixture(scope="module")
def straight_and_first(weights):
    """4 straight steps (their losses and final state), and a coach after
    the first 2 of them."""
    xs = batches(90, 4)
    _, straight = make_coaches(weights, jax_side=False, **CKPT_KW)
    want = _run_steps(straight, xs)
    _, first = make_coaches(weights, jax_side=False, **CKPT_KW)
    _run_steps(first, xs[:2])
    return xs, want, _port_state(straight), first


@pytest.mark.parametrize("backend", ["pickle", "dir"])
def test_checkpoint_resume_equals_straight_run(weights, straight_and_first,
                                               tmp_path, backend):
    """2 steps, save, a fresh coach, load, 2 more: the same params, and
    Ranger's and the discriminator's Adam states, as 4 straight steps. The
    checkpoint holds no host random state (nor does the JAX package's), so
    the resumed coach is given the z stream's position."""
    xs, want, straight, first = straight_and_first
    path = str(tmp_path / ("ckpt" if backend == "dir" else "ckpt.pkl"))
    first.save_checkpoint(path, backend=backend)
    _, resumed = make_coaches(weights, jax_side=False, **CKPT_KW)
    resumed.load_checkpoint(path)
    assert resumed.global_step == 2
    resumed._rng.set_state(first._rng.get_state())
    got = _run_steps(resumed, xs[2:])
    assert got == want[2:]
    _assert_same(_port_state(resumed), straight)
    assert resumed.optimizer.state["1"]["count"] == 4
