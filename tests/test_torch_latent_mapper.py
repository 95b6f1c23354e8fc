"""The port's latent-mapper trainer against the JAX package's, on the CPU
(fp32), on test_torch_find_direction.py's `setup` (tiny_gen 32 px, the tiny
CLIP towers and ArcFace, 12 items) with JAX's mapper weights carried
across.

The JAX side of the one-loss test runs in float64 (jax.enable_x64), the
exact reference. Tolerances: one loss (the mapper's edit rendered by a
second generator) rtol 1e-5 and each of the 20 mapper gradients relative
L2 1e-4; a training run's loss history, callback loss and gradient norm
rtol 1e-4 and the mapper's outputs relative L2 1e-4 (at learning rate 0;
see `test_train_latent_mapper_matches_jax` for the moving run); Adam's
update 1e-7; the CLIs' renders ±1 per uint8.
"""

import functools
import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu.models import mapper as jmap
from stylemc_tpu.models.clip import FallbackTokenizer as JaxTokenizer
from stylemc_tpu.models.stylegan2.generator import init_generator_params
from stylemc_torch.convert import params_from_numpy
from stylemc_torch.models import mapper as tmap
from stylemc_torch.models.clip import FallbackTokenizer
from stylemc_torch.train import latent_mapper as tlm
from stylemc_torch.train.find_direction import TRAINABLE
from test_torch_find_direction import (  # noqa: F401
    _kw, cli_files, setup, tiny_arcface_clis)
from tiny import TINY_ARCFACE_LAYOUT
from torch_threads import (  # noqa: F401
    default_torch_threads, one_torch_thread)

jfd = importlib.import_module("stylemc_tpu.train.find_direction")
jlm = importlib.import_module("stylemc_tpu.train.latent_mapper")
tfd = importlib.import_module("stylemc_torch.train.find_direction")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mkw(**kw):
    """`setup`'s trainer keywords with the mapper CLI's coefficients."""
    base = dict(learning_rate=5e-4, identity_loss_coef=0.3, l2_reg_coef=0.8,
                clip_loss_coef=2.0, landmarks_loss_coef=0.0)
    base.update(kw)
    return _kw(**base)


@pytest.fixture(scope="module")
def mapper_weights():
    jp = jmap.init_mapper_params(jax.random.PRNGKey(5))
    return jp, jmap.params_to_torch_state(jp)


def _f64(tree):
    """A JAX tree with its float leaves in float64 (inside jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _jax_setup_f64(jax_side):
    """(gen params, CLIP models, ArcFace) of `setup` in float64."""
    gen_cfg, gen_params, clips, arc = jax_side
    return (_f64(gen_params), {k: (c, _f64(p)) for k, (c, p) in clips.items()},
            _f64(arc))


def test_loss_and_mapper_gradient_with_second_generator_match_jax(
        setup, mapper_weights):
    jax_side, torch_side, styles = setup
    gen_cfg, gen_params, clips, arc = jax_side
    cfg, gp, tclips, tarc = torch_side
    p2 = init_generator_params(jax.random.PRNGKey(7), gen_cfg)
    jp, state = mapper_weights
    s4 = styles[:4]
    slope = 0.01

    def jedit(mp, st):
        return st.at[:, TRAINABLE].add(jmap.mapper_apply(
            mp, st[:, TRAINABLE], slope))

    with jax.enable_x64(True):
        gp64, clips64, arc64 = _jax_setup_f64(jax_side)
        jmtc = jlm.MapperTrainConfig(**_mkw(clip_type="double",
                                            perception_dtype="float64"))
        jb = jfd.make_clip_bundles(jmtc, clips64, JaxTokenizer())
        jid, jclip = jfd.precompute_original_features(
            gp64, gen_cfg, _f64(s4), jb, arc64, jmtc)
        jloss = jfd.make_loss_fn(gp64, gen_cfg, jb, arc64, jmtc,
                                 edit_fn=jedit, edit_gen=(_f64(p2), gen_cfg))
        (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            _f64(jp), _f64(s4), jid, jclip)
        jl, jaux = float(jl), {k: float(v) for k, v in jaux.items()}
        want = jmap.params_to_torch_state(jg)

    tmtc = tlm.MapperTrainConfig(**_mkw(clip_type="double"))
    tb = tfd.make_clip_bundles(tmtc, tclips, FallbackTokenizer())
    tid, tclip = tfd.precompute_original_features(
        gp, cfg, torch.from_numpy(s4), tb, tarc, tmtc)
    mapper = tmap.params_from_torch_state(state, "cpu")

    def tedit(m, st):
        return st + tfd.assemble_direction(
            tmap.mapper_apply(m, st[:, TRAINABLE], slope))

    tloss = tfd.make_loss_fn(gp, cfg, tb, tarc, tmtc, edit_fn=tedit,
                             edit_gen=(params_from_numpy(p2, "cpu"), cfg))
    tl, taux = tloss(mapper, torch.from_numpy(s4), tid, tclip)
    tl.backward()
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    for k in ("clip_loss", "identity_loss", "l2_loss"):
        np.testing.assert_allclose(float(taux[k]), jaux[k], rtol=1e-5)
    got = {k: p.grad.numpy() for k, p in mapper.named_parameters()}
    assert sorted(got) == sorted(want) and len(got) == 20
    # JAX's own fp32 gradient of the same loss on the same inputs. On the
    # medium rows both packages read 1.1e-4 to 1.45e-4 from float64, each
    # within 0.2 % of the other: fp32 rounds the L2 term's (s + delta) - s
    # alike in either. There the port is held within JAX's own reading; on
    # every other leaf within 1e-4, as before. JAX's coarse rows read 3e-3:
    # one pre-activation sits at the leaky-ReLU kink, which JAX's fp32
    # crosses (test_train_latent_mapper_matches_jax), so a reading beyond
    # 2e-4 does not raise the bound. JAX's reads at least a third of 1e-4
    # on every leaf, so the bound is not slack above fp32's floor.
    jmtc32 = jlm.MapperTrainConfig(**_mkw(clip_type="double"))
    jb32 = jfd.make_clip_bundles(jmtc32, clips, JaxTokenizer())
    jid32, jclip32 = jfd.precompute_original_features(
        gen_params, gen_cfg, s4, jb32, arc, jmtc32)
    jloss32 = jfd.make_loss_fn(gen_params, gen_cfg, jb32, arc, jmtc32,
                               edit_fn=jedit, edit_gen=(p2, gen_cfg))
    _, jg32 = jax.jit(jax.value_and_grad(jloss32, has_aux=True))(
        jp, jnp.asarray(s4), jid32, jclip32)
    jax32 = jmap.params_to_torch_state(jg32)
    for k in want:
        jax_reading = _rel_l2(jax32[k], want[k])
        bound = jax_reading if 1e-4 < jax_reading <= 2e-4 else 1e-4
        assert _rel_l2(got[k], want[k]) <= bound, (k, bound)
        assert jax_reading >= 1e-4 / 3, k
    # the second generator renders the edit: the loss differs without it
    plain, _ = tfd.make_loss_fn(gp, cfg, tb, tarc, tmtc, edit_fn=tedit)(
        mapper, torch.from_numpy(s4), tid, tclip)
    assert abs(float(plain) - float(tl)) > 1e-4


def test_train_latent_mapper_matches_jax(setup, mapper_weights):
    """Two runs from the same start against JAX's trainer.

    At learning rate 0 (four epochs of 3 steps, batch 4) the weights stay
    put, so every step's loss, the callback at iteration 10 and its
    gradient norm (the sum of the 20 per-weight norms) compare the batch
    stream, the schedule and the cadence without any drift: rtol 1e-4.

    At the reference learning rate (one epoch, 3 steps) the first loss is
    held at rtol 1e-5 and the run must move. The later steps are not held
    to JAX's: with this start one pre-activation of an item's 16² conv0
    sits within fp32 rounding of the leaky-ReLU kink, so the two packages'
    fp32 gradients for the coarse rows differ there, and Adam's normalised
    first steps turn that into weight differences of up to 2·lr
    (`test_adam_update_matches_optax` holds the update rule itself).
    """
    jax_side, torch_side, styles = setup
    gen_cfg, gen_params, clips, arc = jax_side
    cfg, gp, tclips, tarc = torch_side
    jp, state = mapper_weights
    x = styles[:, TRAINABLE]
    start = np.asarray(jmap.mapper_apply(jp, jnp.asarray(x)))

    def port(seen, **kw):
        return tlm.train_latent_mapper(
            gp, cfg, styles, tclips, tarc,
            tlm.MapperTrainConfig(**_mkw(clip_type="small", **kw)),
            tokenizer=FallbackTokenizer(), resume_params=state,
            callback=lambda it, loss, aux, lr, gn, mp: seen.append(
                (it, loss, aux, lr, gn)))

    jseen, tseen = [], []
    jm, jinfo = jlm.train_latent_mapper(
        gen_params, gen_cfg, styles, clips, arc,
        jlm.MapperTrainConfig(**_mkw(clip_type="small", n_epochs=4,
                                     learning_rate=0.0)),
        tokenizer=JaxTokenizer(), resume_params=jp,
        callback=lambda it, loss, aux, lr, gn, mp: jseen.append(
            (it, loss, aux, lr, gn)))
    tm, tinfo = port(tseen, n_epochs=4, learning_rate=0.0)
    assert tinfo["iterations"] == jinfo["iterations"] == 12
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-4)
    assert len(set(np.round(tinfo["history"], 4))) > 3  # batches differ
    assert [s[0] for s in tseen] == [s[0] for s in jseen] == [10]
    (_, tl, taux, tlr, tgn), (_, jl, jaux, jlr, jgn) = tseen[0], jseen[0]
    assert tlr == jlr
    np.testing.assert_allclose([tl, tgn], [jl, jgn], rtol=1e-4)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-4)
    got = tmap.mapper_apply(tm, torch.from_numpy(x)).detach().numpy()
    assert _rel_l2(got, np.asarray(jmap.mapper_apply(
        jm, jnp.asarray(x)))) <= 1e-4
    np.testing.assert_allclose(got, start, rtol=0, atol=1e-5)

    # the moving run's first step is the stationary run's first: the same
    # weights and the same first batch
    tm, tinfo = port([], n_epochs=1)
    assert tinfo["iterations"] == 3
    np.testing.assert_allclose(tinfo["history"][0], jinfo["history"][0],
                               rtol=1e-5)
    assert np.isfinite(tinfo["history"]).all()
    got = tmap.mapper_apply(tm, torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - start).max() > 1e-3  # it trained

    # the caller's mapper is not trained in place, and a mesh is a
    # parallel.DataMesh (test_torch_parallel.py trains over one)
    fresh = tmap.params_from_torch_state(state, "cpu")
    again, _ = tlm.train_latent_mapper(
        gp, cfg, styles, tclips, tarc,
        tlm.MapperTrainConfig(**_mkw(clip_type="small", n_epochs=0)),
        tokenizer=FallbackTokenizer(), resume_params=fresh)
    for k, v in tmap.params_to_torch_state(fresh).items():
        np.testing.assert_array_equal(v, state[k])
        np.testing.assert_array_equal(tmap.params_to_torch_state(again)[k], v)
    with pytest.raises(TypeError, match="DataMesh"):
        tlm.train_latent_mapper(gp, cfg, styles, tclips, tarc,
                                tlm.MapperTrainConfig(**_mkw()),
                                mesh=object())
    for field in ("resolution", "batch_size", "learning_rate", "n_epochs",
                  "identity_loss_coef", "landmarks_loss_coef", "l2_reg_coef",
                  "clip_loss_coef", "mapper_neg_slope"):
        assert getattr(tlm.MapperTrainConfig(), field) == \
            getattr(jlm.MapperTrainConfig(), field), field


def test_adam_update_matches_optax():
    """The trainer's update rule: torch's Adam (betas 0.9/0.999, eps 1e-8)
    with the learning rate set before each step, against optax's adam
    under inject_hyperparams, as the JAX trainer runs it, over five steps
    at cosine learning rates from the same weights and gradients."""
    import optax

    rng = np.random.RandomState(0)
    w0 = {"a": rng.randn(64, 32).astype(np.float32) * 0.05,
          "b": np.zeros((32,), np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-9, -1, v.shape)
                  ).astype(np.float32) for k, v in w0.items()}
             for _ in range(5)]
    lrs = [tfd.cosine_lr(5e-4, it, 5) for it in range(1, 6)]

    opt = optax.inject_hyperparams(optax.adam)(learning_rate=5e-4, b1=0.9,
                                               b2=0.999)
    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    st = opt.init(jw)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in w0.items()}
    topt = torch.optim.Adam(params.values(), lr=5e-4, betas=(0.9, 0.999),
                            eps=1e-8)
    for g, lr in zip(grads, lrs):
        st.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                             jw)
        jw = optax.apply_updates(jw, upd)
        for group in topt.param_groups:
            group["lr"] = lr
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in w0:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jw[k]), rtol=0, atol=1e-7)
        assert np.abs(params[k].detach().numpy() - w0[k]).max() > 1e-4


def test_landmarks_in_graph_run_is_finite(setup):
    """The mapper trainer with the in-graph landmarks loss (a stub
    landmarker without MTCNN: every face takes the full-frame box), as
    tests/test_find_direction.py runs JAX's."""
    from stylemc_tpu.models.mobilenet import init_mobilenet_gdconv_params

    _, torch_side, styles = setup
    cfg, gp, tclips, tarc = torch_side
    landmarker = types.SimpleNamespace(
        mtcnn=None, params=params_from_numpy(
            init_mobilenet_gdconv_params(jax.random.PRNGKey(4)), "cpu"))
    mtc = tlm.MapperTrainConfig(
        resolution=32, batch_size=4, n_epochs=1, learning_rate=0.05,
        clip_type="small", arcface_layout=TINY_ARCFACE_LAYOUT,
        landmarks_in_graph=True, landmarks_loss_coef=10.0)
    _, info = tlm.train_latent_mapper(gp, cfg, styles[:4], tclips, tarc, mtc,
                                      tokenizer=FallbackTokenizer(),
                                      landmarker=landmarker)
    assert info["iterations"] == 1 and np.isfinite(info["history"]).all()
    with pytest.raises(ValueError, match="needs a landmarker"):
        tlm.train_latent_mapper(gp, cfg, styles[:4], tclips, tarc, mtc,
                                tokenizer=FallbackTokenizer())


def test_cli_trains_and_generate_fromS_renders_like_jax(
        cli_files, tiny_arcface_clis, monkeypatch, tmp_path,
        default_torch_threads):
    """train_latent_mapper writes mapper_{prompt}.pth; the port's
    generate_fromS --use_mapper 1 --use_whitelist 1 renders it within ±1 of
    JAX's CLI (mapper_directions_batched and apply_edit_batch) on the same
    file."""
    from stylemc_torch.cli.generate_fromS import main as generate_fromS
    from stylemc_torch.cli.train_latent_mapper import main as train
    from stylemc_tpu.cli.generate_fromS import main as jax_generate_fromS

    monkeypatch.setattr(tlm, "MapperTrainConfig", functools.partial(
        tlm.MapperTrainConfig, arcface_layout=TINY_ARCFACE_LAYOUT))
    root, pkl, s_file, _, env = cli_files
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outdir = str(tmp_path / "out")
    r = CliRunner().invoke(train, [
        "--network", pkl, "--network2", pkl, "--s_input", s_file,
        "--outdir", outdir, "--text_prompt", "a smiling face",
        "--resolution", "32", "--n_epochs", "3", "--batch_size", "2",
        "--clip_type", "small", "--device", "cpu", "--allow_random_init"],
        catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert "Iteration 10, gradient norm:" in r.output
    assert "Total loss:" in r.output and "l2 loss:" in r.output
    path = os.path.join(outdir, "mapper_a_smiling_face.pth")
    sd = torch.load(path, weights_only=True)
    assert len(sd) == 20 and all(v.device.type == "cpu" for v in sd.values())
    assert os.path.exists(os.path.join(outdir, "wandb_log.jsonl"))

    args = ["--network", pkl, "--s_input", s_file, "--text_prompt",
            "a smiling face", "--use_mapper", "1", "--use_whitelist", "1",
            "--change_power", "1.0", "--batch", "4"]
    jdir = str(tmp_path / "jax")
    os.makedirs(jdir)
    os.link(path, os.path.join(jdir, "mapper_a_smiling_face.pth"))
    r = CliRunner().invoke(generate_fromS, args + ["--outdir", outdir,
                                                   "--device", "cpu"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    r = CliRunner().invoke(jax_generate_fromS, args + ["--outdir", jdir],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    names = [f"a_smiling_face_{i:03d}.jpeg" for i in range(8)]
    for name in names:
        got = np.asarray(Image.open(os.path.join(outdir, name)))
        want = np.asarray(Image.open(os.path.join(jdir, name)))
        assert got.shape == (32, 64, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.abs(got[:, :32].astype(int)
                      - got[:, 32:].astype(int)).max() > 0
