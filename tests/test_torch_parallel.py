"""The port's data parallelism (`stylemc_torch/parallel/`) against the JAX
package's mesh paths, on the CPU (fp32).

JAX runs on conftest's 8 virtual CPU devices; the port's meshes are
repeated `cpu` devices, each a shard of its own (the weights shared, as
two shards of one card share them). Tolerances:

* the mesh arithmetic (`data_mesh`, `zoo_mesh`, `best_zoo_mesh`) over
  every device count 1-8 x prompts 1-8 x batch 1-8: sizes, axis names and
  shapes equal;
* `moments`, `report`, `report0` and `Collector`: rtol 1e-12;
* `find_direction(mesh=)` (test_torch_find_direction.py's setup, batch 4
  over 2 shards) against JAX's 2-device mesh run: loss history rtol 1e-4,
  direction atol 1e-4 (find_direction's parity figures; JAX's own mesh
  test holds rtol 5e-2 / atol 5e-3), and against the port's unsharded run:
  the same;
* `optimize_batch` on a 1-axis and a 2-axis mesh against JAX's: each
  prompt's update (direction − start) at cosine > 0.99999 and norms rtol
  1e-4, the loss history rtol 1e-4;
* the generator's features, FID and PPL with `mesh=` against JAX's mesh
  runs on the same z and t: features rtol 1e-4 / atol 1e-4 (JAX's own
  mesh test), FID and PPL (ε 1e-2) rtol 1e-4;
* `BatchEditor(mesh=)` against JAX's mesh editor: uint8 ±1, and a bucket
  the mesh does not divide against the plain path;
* `Coach(mesh=)` against the port's unsharded coach, 2 steps with R1
  (and with the W pool): every loss and the encoder after the steps within
  2e-4 relative; one train_decoder gradient relative L2 2e-4;
* `train_latent_mapper(mesh=)` against the unsharded run at learning
  rate 0: history, callback loss and grad norm rtol 1e-5;
* two processes over gloo (tests/torch_multiprocess_worker.py): a
  data-parallel step against JAX's full-batch step and the port's
  (history rtol 1e-4, direction atol 1e-4), the two ranks' directions
  bit-equal, append_multihost process-major, Collector over the union;
* each CLI's --data_parallel on --device cpu: the mesh resolves to none
  and the output equals the run without the flag.
"""

import functools
import importlib
import json
import os
import random
import sys

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from stylemc_tpu.models.clip import FallbackTokenizer as JaxTokenizer
from stylemc_tpu.parallel import mesh as jmesh
from stylemc_tpu.parallel import stats as jstats
from stylemc_torch.bench import dp_ranks
from stylemc_torch.io import save_native
from stylemc_torch.models.clip import FallbackTokenizer
from stylemc_torch.parallel import mesh as tmesh
from stylemc_torch.parallel import stats as tstats
from stylemc_torch.train import find_direction as tfd
from stylemc_torch.train import latent_mapper as tlm
from test_torch_coach import (  # noqa: F401
    COACH_KW, GEN_KW as COACH_GEN_KW, _paths, _rel_l2, batches, weights)
from test_torch_find_direction import (  # noqa: F401
    _kw, _resume, cli_files, setup, tiny_arcface_clis)
from test_torch_metrics import (  # noqa: F401
    _jax_ppl_pairs, gens, metric_opts)
from test_torch_train_e4e import files, tiny_clis  # noqa: F401
from tiny import TINY_ARCFACE_LAYOUT
from torch_threads import one_torch_thread  # noqa: F401

jfd = importlib.import_module("stylemc_tpu.train.find_direction")
HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
PROMPTS = ["a smiling face", "an old face"]


def cpus(n):
    return [CPU] * n


# ------------------------------------------------------------- arithmetic


def _desc(m):
    """(axis names, shape, size) of either package's mesh, or None."""
    if m is None:
        return None
    return tuple(m.axis_names), dict(m.shape), int(np.size(m.devices))


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_mesh_arithmetic_matches_jax(n_dev):
    jd, td = jax.devices()[:n_dev], cpus(n_dev)
    for b in range(1, 9):
        assert _desc(tmesh.data_mesh(max_size=b, devices=td)) == \
            _desc(jmesh.data_mesh(max_size=b, devices=jd)), b
        for p in range(1, 9):
            assert _desc(tmesh.best_zoo_mesh(p, b, devices=td)) == \
                _desc(jmesh.best_zoo_mesh(p, b, devices=jd)), (p, b)
    assert _desc(tmesh.data_mesh(devices=td)) == \
        _desc(jmesh.data_mesh(devices=jd))
    for p in range(1, 9):
        if n_dev % p:
            with pytest.raises(AssertionError):
                tmesh.zoo_mesh(p, devices=td)
        else:
            assert _desc(tmesh.zoo_mesh(p, devices=td)) == \
                _desc(jmesh.zoo_mesh(p, devices=jd)), p


def test_mesh_layout_and_placement():
    m = tmesh.zoo_mesh(2, devices=cpus(4))
    assert m.shape == {"prompt": 2, "data": 2} and m.distinct == (CPU,)
    groups = m.prompt_groups()
    assert [g.size for g in groups] == [2, 2] and m.group_device(1) == CPU
    assert tmesh.data_mesh(devices=cpus(3)).prompt_groups() == [None] * 3
    with tmesh.data_mesh(devices=cpus(2)) as mesh:
        x = torch.arange(12.0).reshape(6, 2)
        shards = tmesh.shard_batch(mesh, x)
        assert [s.shape[0] for s in shards] == [3, 3]
        torch.testing.assert_close(torch.cat(shards), x)
        a, b = tmesh.shard_batch(mesh, x, x + 1)
        assert len(a) == len(b) == 2
        with pytest.raises(AssertionError):
            tmesh.shard_batch(mesh, x[:5])
        tree = {"w": x, "l": [x], "t": (x, 1)}
        rep = tmesh.replicate(tree, mesh)
        assert list(rep) == [CPU] and rep[CPU]["w"] is x
        assert tmesh.shard_rows(mesh, 4) == [(CPU, slice(0, 2)),
                                             (CPU, slice(2, 4))]
    with pytest.raises(TypeError, match="DataMesh"):
        tmesh.as_mesh(object())
    with pytest.raises(ValueError):
        tmesh.DataMesh([])


def test_default_devices_need_cuda_and_cli_mesh(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.data_mesh()
    assert tmesh.cli_mesh(True, 4, "cpu") is None
    assert tmesh.cli_mesh(False, 4, "cpu") is None
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(tmesh, "default_devices", lambda: cards)
    got = tmesh.cli_mesh(True, 2, torch.device("cuda", 1))
    assert got.devices == (cards[1], cards[0])   # the card asked for first
    assert tmesh.cli_mesh(True, 6, torch.device("cuda", 0)).size == 3
    assert tmesh.cli_mesh(True, 3, torch.device("cuda", 0)).size == 3
    assert tmesh.cli_mesh(True, 1, torch.device("cuda", 0)) is None
    assert tmesh.cli_mesh(False, 4, torch.device("cuda", 0)) is None
    zoo = tmesh.cli_zoo_mesh(True, 2, 4, torch.device("cuda", 0))
    assert zoo.shape == {"prompt": 2, "data": 2}


def test_initialize_distributed_single_process_noop():
    tmesh.initialize_distributed(num_processes=None)
    tmesh.initialize_distributed("127.0.0.1:1", num_processes=1)
    assert not tmesh.distributed()
    assert tmesh.process_count() == 1 and tmesh.process_index() == 0
    x = [torch.ones(3)]
    assert tmesh.all_reduce_sum(x)[0] is x[0]
    rows = np.ones((2, 3), np.float32)
    assert tmesh.all_gather_rows(rows) is rows


# ------------------------------------------------------------------- stats


def test_stats_match_jax():
    rng = np.random.RandomState(0)
    # scalars: each report's moments are exact in float32 on both sides;
    # vectors of multiples of 1/64: their sums are exact too
    scalars = rng.randn(20).astype(np.float32)
    vec = (rng.randint(-64, 64, (5, 8)) / 64).astype(np.float32)
    for v in (scalars[0], vec[0]):
        np.testing.assert_allclose(tstats.moments(v).numpy(),
                                   np.asarray(jstats.moments(v)), rtol=1e-12)
    views = []
    for mod in (tstats, jstats):
        mod._counters.clear()
        c = mod.Collector(regex="loss/.*")
        for v in scalars:
            mod.report("loss/a", v)
        for v in vec:
            mod.report0("loss/b", v)
        mod.report("other", 1.0)
        c.update()
        first = c.as_dict()
        mod.report("loss/a", 3.0)
        c.update()
        views.append((first, c.as_dict(), c.names(),
                      mod._counters["loss/a"].tolist(),
                      (c.num("nope"), c.mean("nope"), c.std("nope"))))
    (t1, t2, tn, tz, tnope), (j1, j2, jn, jz, jnope) = views
    assert tn == jn == ["loss/a", "loss/b"] and tz == jz == [0, 0, 0]
    for t, j in ((t1, j1), (t2, j2)):
        assert sorted(t) == sorted(j) == ["loss/a", "loss/b"]
        for name in j:
            assert t[name]["num"] == j[name]["num"]
            for k in ("mean", "std"):
                np.testing.assert_allclose(t[name][k], j[name][k],
                                           rtol=1e-12)
    assert tnope[0] == jnope[0] == 0
    assert np.isnan(tnope[1]) and np.isnan(tnope[2])


def test_report0_only_on_process_zero(monkeypatch):
    tstats._counters.clear()
    tstats.report0("p0_stat", 1.0)
    assert tstats._counters["p0_stat"][0] == 1
    monkeypatch.setattr(tstats, "process_index", lambda: 1)
    tstats.report0("p0_stat", 1.0)
    assert tstats._counters["p0_stat"][0] == 1  # unchanged on rank 1


# ---------------------------------------------------------- find_direction


def _port_run(setup, mesh=None, **kw):  # noqa: F811
    _, (cfg, gp, clips, arc), styles = setup
    return tfd.find_direction(gp, cfg, styles, clips, arc,
                              tfd.FindDirectionConfig(**_kw(**kw)),
                              tokenizer=FallbackTokenizer(), mesh=mesh,
                              resume_direction=_resume())


@pytest.fixture(scope="module")
def dp_runs(setup):  # noqa: F811
    """The port's run sharded over 2 shards and unsharded, clip_type
    'small', computed once."""
    return (_port_run(setup, tmesh.data_mesh(devices=cpus(2)),
                      clip_type="small"),
            _port_run(setup, clip_type="small"))


def _close_runs(got, want, what):
    (gd, gi), (wd, wi) = got, want
    assert gi["iterations"] == wi["iterations"] == 3, what
    np.testing.assert_allclose(gi["history"], wi["history"], rtol=1e-4,
                               err_msg=what)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(wd), rtol=0,
                               atol=1e-4, err_msg=what)


def test_find_direction_mesh_matches_jax_mesh(setup, dp_runs):  # noqa: F811
    (gen_cfg, gen_params, clips, arc), _, styles = setup
    mesh = jmesh.data_mesh(max_size=2)
    assert mesh.devices.size == 2
    want = jfd.find_direction(
        gen_params, gen_cfg, styles, clips, arc,
        jfd.FindDirectionConfig(**_kw(clip_type="small")),
        tokenizer=JaxTokenizer(), mesh=mesh, resume_direction=_resume())
    sharded, _ = dp_runs
    _close_runs((sharded[0].numpy(), sharded[1]), want, "port vs JAX mesh")
    d = sharded[0].numpy()
    assert np.abs(d - _resume()).max() > 1e-3  # it moved


def test_find_direction_mesh_matches_unsharded(setup, dp_runs):  # noqa: F811
    sharded, plain = dp_runs
    _close_runs(sharded, plain, "sharded vs unsharded")
    # a mesh of 4 shards (1 row each) and of 1 shard: the same run
    for n in (1, 4):
        _close_runs(_port_run(setup, tmesh.data_mesh(devices=cpus(n)),
                              clip_type="small"), plain, f"{n} shards")
    # the batch must divide over the mesh, as JAX's sharding asserts
    with pytest.raises(AssertionError, match="does not divide"):
        _port_run(setup, tmesh.data_mesh(devices=cpus(3)),
                  clip_type="small")


def test_find_direction_mesh_nada_and_double(setup):  # noqa: F811
    """The NADA losses (each image's edit normalised on its own) and the
    double CLIP term split as the default one does."""
    for kw in ({"clip_type": "double"},
               {"clip_type": "double", "clip_loss_type": "nada"}):
        _close_runs(_port_run(setup, tmesh.data_mesh(devices=cpus(2)), **kw),
                    _port_run(setup, **kw), str(kw))


# ----------------------------------------------------------- optimize_batch


def _update_cos(d, starts):
    d = np.asarray(d).reshape(len(starts), -1)
    u = d - np.stack([s.ravel() for s in starts])
    return u


@pytest.mark.parametrize("axes", ["prompt", "prompt_data"])
def test_optimize_batch_mesh_matches_jax(setup, axes):  # noqa: F811
    (gen_cfg, gen_params, clips, arc), (cfg, gp, tclips, tarc), styles = setup
    kw = _kw(clip_type="small", text_prompt=PROMPTS[0],
             negative_text_prompt="a face")
    j = jfd.DirectionEngine(gen_params, gen_cfg, styles, clips, arc,
                            jfd.FindDirectionConfig(**kw),
                            tokenizer=JaxTokenizer())
    t = tfd.DirectionEngine(gp, cfg, styles, tclips, tarc,
                            tfd.FindDirectionConfig(**kw),
                            tokenizer=FallbackTokenizer())
    starts = [_resume(5), _resume(6)]
    if axes == "prompt":
        jm, tm = jmesh.data_mesh(max_size=2), tmesh.data_mesh(
            devices=cpus(2))
    else:
        jm = jmesh.zoo_mesh(2, devices=jax.devices()[:4])
        tm = tmesh.zoo_mesh(2, devices=cpus(4))
        assert tm.shape == dict(jm.shape) == {"prompt": 2, "data": 2}
    jd, jinfo = j.optimize_batch(PROMPTS, mesh=jm, resume_directions=starts)
    td, tinfo = t.optimize_batch(PROMPTS, mesh=tm, resume_directions=starts)
    assert td.shape == (2, 1, 26, 512) and tinfo["history"].shape == (2, 3)
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-4)
    ut, uj = _update_cos(td.numpy(), starts), _update_cos(jd, starts)
    cos = (ut * uj).sum(1) / (np.linalg.norm(ut, axis=1)
                              * np.linalg.norm(uj, axis=1))
    assert (cos > 0.99999).all(), cos
    np.testing.assert_allclose(np.linalg.norm(ut, axis=1),
                               np.linalg.norm(uj, axis=1), rtol=1e-4)
    # against the port's unsharded batched run: the same figures
    pd, pinfo = t.optimize_batch(PROMPTS, resume_directions=starts)
    np.testing.assert_allclose(tinfo["history"], pinfo["history"], rtol=1e-4)
    np.testing.assert_allclose(td.numpy(), pd.numpy(), rtol=0, atol=1e-4)
    # a prompt count the 'prompt' axis does not divide is refused
    with pytest.raises(AssertionError, match="prompts over"):
        t.optimize_batch(PROMPTS[:1], mesh=tm)


def test_optimize_batch_refuses_a_non_mesh(setup):  # noqa: F811
    _, (cfg, gp, tclips, tarc), styles = setup
    t = tfd.DirectionEngine(gp, cfg, styles[:4], tclips, tarc,
                            tfd.FindDirectionConfig(**_kw(clip_type="small")),
                            tokenizer=FallbackTokenizer())
    with pytest.raises(TypeError, match="DataMesh"):
        t.optimize_batch(PROMPTS, mesh=object())
    with pytest.raises(AssertionError, match="'data' shards"):
        t.optimize_batch(PROMPTS, mesh=tmesh.zoo_mesh(2, devices=cpus(6)))


# ----------------------------------------------------------------- metrics


@pytest.fixture(scope="module")
def lpips_nets():
    """test_torch_metrics.py's LPIPS-VGG alone (no metric here reads the
    other two nets)."""
    from stylemc_tpu.losses import lpips as jlpips
    from stylemc_torch.convert import params_from_numpy

    jp = jlpips.init_lpips_params(jax.random.PRNGKey(1), "vgg")
    return {"vgg": (jp, params_from_numpy(jp, "cpu"))}


def test_generator_features_mesh_matches_jax(metric_opts):
    """The images each package's mesh run hands its detector, and the
    port's plain run's, agree within ±1 per uint8: a batch of 4 and one of
    16 take different CPU convolution sums, so a value can cross a rounding
    edge (moving the linear detector's features by up to ~0.06). The
    features' mean over the 32 images, what FID reads, within rtol 1e-4
    of JAX's mesh run's."""
    import dataclasses

    from stylemc_tpu.metrics.metric_main import (
        compute_generator_features as jcgf)
    from stylemc_torch.metrics.metric_main import (
        compute_generator_features as tcgf)

    jo, to = metric_opts
    seen = {"jax": [], "port": [], "plain": []}

    def recording(fn, key):
        def f(imgs):
            seen[key].append(np.asarray(imgs))
            return fn(imgs)
        return f

    jm = dataclasses.replace(jo, mesh=jmesh.data_mesh())
    tm = dataclasses.replace(to, mesh=tmesh.data_mesh(devices=cpus(4)))
    want = jcgf(jm, recording(jm.inception_features_fn, "jax"), 32,
                capture_all=True)
    got = tcgf(tm, recording(tm.inception_features_fn, "port"), 32,
               capture_all=True)
    tcgf(to, recording(to.inception_features_fn, "plain"), 32,
         capture_all=True)
    a, b, c = (np.concatenate(seen[k]) for k in ("port", "jax", "plain"))
    assert a.dtype == b.dtype == c.dtype == np.uint8
    assert a.shape == b.shape == c.shape == (32, 32, 32, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert np.abs(a.astype(int) - c.astype(int)).max() <= 1
    m, mj = got.get_all().mean(0), want.get_all().mean(0)
    np.testing.assert_allclose(m, mj, rtol=1e-4,
                               atol=1e-4 * np.abs(mj).max())
    bad = dataclasses.replace(to, mesh=tmesh.data_mesh(devices=cpus(3)))
    with pytest.raises(AssertionError, match="must divide"):
        tcgf(bad, to.inception_features_fn, 32, capture_all=True)


def test_calc_metric_fid_mesh_matches_jax(metric_opts):
    import dataclasses

    from stylemc_tpu import metrics as jmetrics
    from stylemc_torch import metrics as tmetrics

    jo, to = metric_opts
    want = jmetrics.calc_metric("fid50k_full", opts=dataclasses.replace(
        jo, mesh=jmesh.data_mesh()))
    got = tmetrics.calc_metric("fid50k_full", opts=dataclasses.replace(
        to, mesh=tmesh.data_mesh(devices=cpus(2))))
    np.testing.assert_allclose(got.results.fid50k_full,
                               want.results.fid50k_full, rtol=1e-4)


def test_compute_ppl_mesh_matches_jax(gens, lpips_nets):  # noqa: F811
    from stylemc_tpu.metrics import ppl as jppl
    from stylemc_tpu.models.stylegan2 import generator as jgen
    from stylemc_torch.metrics import ppl as tppl
    from stylemc_torch.models.stylegan2 import generator as tgen

    cfg, gp, tcfg, tgp = gens
    jl, tl = lpips_nets["vgg"]
    kw = dict(num_samples=8, batch_size=4, epsilon=1e-2)
    want = jppl.compute_ppl(
        lambda g, z: jgen.mapping(g, cfg, z),
        lambda g, w: jgen.synthesis(g, cfg, jgen.w_to_s(g, cfg, w)), jl,
        cfg.z_dim, gen_params=gp, mesh=jmesh.data_mesh(max_size=4), **kw)

    def port(mesh):
        return tppl.compute_ppl(
            lambda g, z: tgen.mapping(g, tcfg, z),
            lambda g, w: tgen.synthesis(g, tcfg, tgen.w_to_s(g, tcfg, w)),
            tl, cfg.z_dim, gen_params=tgp, device="cpu", mesh=mesh,
            latents=_jax_ppl_pairs(0, 8, 4, cfg.z_dim), **kw)

    got = port(tmesh.data_mesh(devices=cpus(2)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, port(None), rtol=1e-5)


# ------------------------------------------------------------------ serving


def test_batch_editor_mesh_matches_jax_mesh_editor():
    from stylemc_tpu.models.stylegan2.generator import (
        GeneratorConfig as JaxConfig, init_generator_params)
    from stylemc_tpu.serve import BatchEditor as JaxEditor
    from stylemc_torch.models.stylegan2.generator import GeneratorConfig
    from stylemc_torch.serve import BatchEditor

    kw = dict(img_resolution=32, channel_base=1024, channel_max=64,
              mapping_layers=2)
    params = init_generator_params(jax.random.PRNGKey(0), JaxConfig(**kw))
    d = np.zeros((1, 26, 512), np.float32)
    d[:, 2, :64] = 0.5
    jed = JaxEditor(JaxConfig(**kw), params, direction=d, max_batch=16,
                    mesh=jmesh.data_mesh())
    ted = BatchEditor(GeneratorConfig(**kw), params, direction=d,
                      max_batch=16, mesh=tmesh.data_mesh(devices=cpus(8)),
                      device="cpu")
    plain = BatchEditor(GeneratorConfig(**kw), params, direction=d,
                        max_batch=16, device="cpu")
    styles = ted.styles_from_seeds(range(16))
    np.testing.assert_allclose(styles.numpy(), np.asarray(
        jed.styles_from_seeds(range(16))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(styles.numpy(),
                               plain.styles_from_seeds(range(16)).numpy(),
                               rtol=1e-5, atol=1e-4)
    want = jed.edit_styles(np.asarray(styles), change_power=1.5)
    got = ted.edit_styles(styles, change_power=1.5)
    assert got.dtype == np.uint8 and got.shape == (16, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - plain.edit_styles(
        styles, change_power=1.5).astype(int)).max() <= 1
    # the batch-16 bucket splits over the mesh; a batch-2 bucket does not
    calls = []
    synthesis = importlib.import_module("stylemc_torch.serve").synthesis

    def counting(params, cfg, s, **kw):
        calls.append(s.shape[0])
        return synthesis(params, cfg, s, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr("stylemc_torch.serve.synthesis", counting)
    try:
        ted.edit_styles(styles, change_power=1.5)
        assert calls == [2] * 8
        calls.clear()
        small = ted.edit_styles(styles[:2], change_power=1.5)
        assert calls == [2]
    finally:
        mp.undo()
    assert np.abs(small.astype(int) - want[:2].astype(int)).max() <= 1


# ------------------------------------------------------------------- coach


def _port_coach(w, mesh=None, **kw):
    from stylemc_torch.convert import params_from_numpy
    from stylemc_torch.models.e4e import psp as tpsp
    from stylemc_torch.models.stylegan2 import generator as tgen
    from stylemc_torch.train import coach as tcoach
    from stylemc_torch.train import ranger as tranger
    from tiny import TINY_ARCFACE_LAYOUT, TINY_E4E_LAYOUT

    tc = tcoach.Coach(
        tcoach.CoachOptions(**dict(COACH_KW, **kw)),
        tpsp.PSP(cfg=tpsp.PSPConfig(256, encoder_layout=TINY_E4E_LAYOUT),
                 encoder_params=params_from_numpy(w["enc"], "cpu"),
                 decoder_cfg=tgen.GeneratorConfig(**COACH_GEN_KW),
                 decoder_params=params_from_numpy(w["gen"], "cpu"),
                 latent_avg=torch.from_numpy(w["latent_avg"])),
        {"lpips": w["lpips"], "arcface": w["arcface"]}, lambda: None,
        arcface_layout=TINY_ARCFACE_LAYOUT, mesh=mesh, device="cpu")
    if tc.discriminator_params is not None:
        with torch.no_grad():
            for p, v in zip(tranger.tree_leaves(tc.discriminator_params),
                            tranger.tree_leaves(params_from_numpy(
                                w["disc"], "cpu"))):
                p.copy_(v)
    return tc


@pytest.mark.parametrize("pool", [False, True], ids=["default", "w_pool"])
def test_coach_mesh_matches_unsharded(weights, pool):  # noqa: F811
    """2 steps (stages 0 and 1, R1 at step 0) over 2 shards of 1 image."""
    kw = dict(progressive_start=1, progressive_step_every=1, d_reg_every=2,
              use_w_pool=pool, w_pool_size=3)
    xs = batches(70, 2)
    runs = []
    for mesh in (None, tmesh.data_mesh(devices=cpus(2))):
        tc = _port_coach(weights, mesh, **kw)
        random.seed(4)
        runs.append(([tc.train_step(x, x.copy()) for x in xs], tc))
    (plain, pc), (sharded, sc) = runs
    for i, (a, b) in enumerate(zip(plain, sharded)):
        assert list(b) == list(a), i
        for k in a:
            assert abs(b[k] - a[k]) <= 2e-4 * max(abs(a[k]), 1e-3), \
                (i, k, b[k], a[k])
    want, got = _paths(pc.psp.encoder_params), _paths(sc.psp.encoder_params)
    cat = lambda t: torch.cat([t[k].detach().reshape(-1) for k in want])  # noqa: E731,E501
    assert _rel_l2(cat(got), cat(want)) <= 2e-4
    dw = torch.cat([p.reshape(-1) for p in _paths(
        pc.discriminator_params).values()])
    dg = torch.cat([p.reshape(-1) for p in _paths(
        sc.discriminator_params).values()])
    assert _rel_l2(dg.detach(), dw.detach()) <= 2e-4


def test_coach_mesh_train_decoder_gradient(weights):  # noqa: F811
    x = torch.from_numpy(batches(80, 1)[0])
    grads = []
    for mesh in (None, tmesh.data_mesh(devices=cpus(2))):
        tc = _port_coach(weights, mesh, train_decoder=True,
                         w_discriminator_lambda=0.0)
        vals, g = tc.encoder_gradients(x, x.clone(), 18)
        grads.append((vals, _paths(g)))
    (va, ga), (vb, gb) = grads
    assert list(vb) == list(va)
    for k in va:
        np.testing.assert_allclose(float(vb[k]), float(va[k]), rtol=2e-4)
    for part in ("/encoder/", "/decoder/"):
        keys = [k for k in ga if k.startswith(part)]
        assert _rel_l2(torch.cat([gb[k].reshape(-1) for k in keys]),
                       torch.cat([ga[k].reshape(-1) for k in keys])) <= 2e-4
    with pytest.raises(AssertionError, match="must divide"):
        _port_coach(weights, tmesh.data_mesh(devices=cpus(3)))


# ------------------------------------------------------------ latent mapper


def test_latent_mapper_mesh_matches_unsharded(setup):  # noqa: F811
    from stylemc_torch.models import mapper as tmap

    _, (cfg, gp, tclips, tarc), styles = setup
    start = tmap.init_mapper_params(torch.Generator().manual_seed(3),
                                    device="cpu")
    state = tmap.params_to_torch_state(start)

    def run(mesh, lr, n_epochs=4):
        seen = []
        m, info = tlm.train_latent_mapper(
            gp, cfg, styles, tclips, tarc,
            tlm.MapperTrainConfig(**_kw(clip_type="small", n_epochs=n_epochs,
                                        batch_size=4, learning_rate=lr)),
            tokenizer=FallbackTokenizer(), mesh=mesh, resume_params=state,
            callback=lambda it, loss, aux, lr_, gn, mp: seen.append(
                (it, loss, gn, aux)))
        return m, info, seen

    mesh = tmesh.data_mesh(devices=cpus(2))
    (pm, pinfo, pseen), (sm, sinfo, sseen) = run(None, 0.0), run(mesh, 0.0)
    assert sinfo["iterations"] == pinfo["iterations"] == 12
    np.testing.assert_allclose(sinfo["history"], pinfo["history"], rtol=1e-5)
    assert [s[0] for s in sseen] == [s[0] for s in pseen] == [10]
    np.testing.assert_allclose(sseen[0][1:3], pseen[0][1:3], rtol=1e-5)
    for k in pseen[0][3]:
        np.testing.assert_allclose(sseen[0][3][k], pseen[0][3][k], rtol=1e-5)
    for k, v in tmap.params_to_torch_state(sm).items():
        np.testing.assert_array_equal(v, state[k])
    # at the reference rate the sharded run moves, its first loss the same
    m, info, _ = run(mesh, 5e-4, n_epochs=1)
    np.testing.assert_allclose(info["history"][0], pinfo["history"][0],
                               rtol=1e-5)
    assert any(np.abs(v - state[k]).max() > 0 for k, v in
               tmap.params_to_torch_state(m).items())
    with pytest.raises(TypeError, match="DataMesh"):
        tlm.train_latent_mapper(gp, cfg, styles, tclips, tarc,
                                tlm.MapperTrainConfig(**_kw()),
                                mesh=object())


# ------------------------------------------------------------ two processes


def test_two_processes_over_gloo(setup, tmp_path):  # noqa: F811
    """Two real processes join a gloo group over 127.0.0.1; each takes 2
    of the batch's 4 rows over a mesh of 2 shards."""
    (gen_cfg, gen_params, clips, arc), (cfg, gp, tclips, tarc), styles = setup
    from stylemc_torch.convert import params_to_numpy

    fdc = _kw(clip_type="small", lr_schedule="constant")
    items = styles[:4]
    want_d, want = jfd.find_direction(
        gen_params, gen_cfg, items, clips, arc, jfd.FindDirectionConfig(**fdc),
        tokenizer=JaxTokenizer(), resume_direction=_resume())
    port_d, port = tfd.find_direction(
        gp, cfg, items, tclips, tarc, tfd.FindDirectionConfig(**fdc),
        tokenizer=FallbackTokenizer(), resume_direction=_resume())
    assert want["iterations"] == port["iterations"] == 1
    net = str(tmp_path / "gen.npz")
    save_native(net, cfg, gp)
    ref = {"history_rtol": 1e-4, "direction_key": "direction_abs",
           "direction_tol": 1e-4}
    spec = dp_ranks.write_spec(
        str(tmp_path / "spec.pkl"), network=net,
        clip={k: (dict(vars(c)), jax.tree_util.tree_map(np.asarray, p))
              for k, (c, p) in clips.items() if k == "ViT-B/32"},
        arcface=params_to_numpy(tarc), styles=items, fdc=fdc,
        resume=_resume(), device="cpu", shards=2, backend="gloo", threads=1,
        refs={"jax": dict(ref, history=want["history"],
                          direction=np.asarray(want_d)),
              "port": dict(ref, history=port["history"],
                           direction=port_d.numpy())})
    port_no = dp_ranks.free_port()
    outs = [str(tmp_path / f"result_{r}.json") for r in range(2)]
    procs = dp_ranks.spawn_group(
        lambda r: [spec, r, 2, port_no, outs[r]], 2, timeout_s=240,
        program=[sys.executable, os.path.join(HERE,
                                              "torch_multiprocess_worker.py")])
    for r, p in enumerate(procs):
        assert p["rc"] == 0 and not p["timed_out"], \
            f"rank {r}: rc {p['rc']}\n{p['output'][-4000:]}"
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    for r, x in enumerate(res):
        assert x["rank"] == r and x["world"] == 2 and x["ok"], x
        assert x["append_multihost"] and x["collector_cross_process"], x
    # both ranks hold the same all-reduced step
    assert res[0]["history"] == res[1]["history"]
    assert res[0]["direction_sum"] == res[1]["direction_sum"]
    assert res[0]["direction_norm"] == res[1]["direction_norm"]


# --------------------------------------------------------------------- CLIs


@pytest.fixture
def mesh_spy(monkeypatch):
    """Record every cli_mesh / cli_zoo_mesh call and what it resolved."""
    seen = []
    for name in ("cli_mesh", "cli_zoo_mesh"):
        fn = getattr(tmesh, name)

        def spy(*a, _fn=fn, _name=name):
            out = _fn(*a)
            seen.append((_name, a[:-1], out))   # without the device
            return out

        monkeypatch.setattr(tmesh, name, spy)
    return seen


def test_find_direction_cli_data_parallel_on_cpu(cli_files, tiny_arcface_clis,
                                                 mesh_spy, monkeypatch):
    from stylemc_torch.cli.find_direction import main

    root, pkl, s_file, r_file, env = cli_files
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = ["--network", pkl, "--s_input", s_file, "--resolution", "32",
            "--n_epochs", "1", "--batch_size", "4", "--resume", r_file,
            "--device", "cpu", "--clip_type", "small"]
    got = {}
    for flag in ("--data_parallel", "--no-data_parallel"):
        for sweep in ([], ["--text_prompts", "a|b", "--batch_prompts"]):
            out = str(root / f"dp{flag}{len(sweep)}")
            r = CliRunner().invoke(main, base + ["--outdir", out, flag]
                                   + sweep, catch_exceptions=False)
            assert r.exit_code == 0, r.output
            got[flag, len(sweep)] = {
                n: np.load(os.path.join(out, n))["s"] for n in
                sorted(os.listdir(out)) if n.startswith("direction_")}
    for n in (0, 3):
        a, b = got["--data_parallel", n], got["--no-data_parallel", n]
        assert sorted(a) == sorted(b) and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert mesh_spy == [
        ("cli_mesh", (True, 4), None), ("cli_zoo_mesh", (True, 2, 4), None),
        ("cli_mesh", (False, 4), None), ("cli_zoo_mesh", (False, 2, 4),
                                         None)]


def test_mapper_cli_data_parallel_on_cpu(cli_files, tiny_arcface_clis,
                                         mesh_spy, monkeypatch):
    from stylemc_torch.cli.train_latent_mapper import main
    from stylemc_torch.io import load_state_dict_numpy

    monkeypatch.setattr(tlm, "MapperTrainConfig", functools.partial(
        tlm.MapperTrainConfig, arcface_layout=TINY_ARCFACE_LAYOUT))
    root, pkl, s_file, _, env = cli_files
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for flag in ("--data_parallel", "--no-data_parallel"):
        out = str(root / f"mapper{flag}")
        r = CliRunner().invoke(main, [
            "--network", pkl, "--s_input", s_file, "--outdir", out,
            "--text_prompt", "a face", "--resolution", "32", "--n_epochs",
            "1", "--batch_size", "2", "--clip_type", "small", "--device",
            "cpu", flag], catch_exceptions=False)
        assert r.exit_code == 0, r.output
        got.append(load_state_dict_numpy(os.path.join(out,
                                                      "mapper_a_face.pth")))
    assert sorted(got[0]) == sorted(got[1])
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k])
    assert [(a, o) for _, a, o in mesh_spy] == [((True, 2), None),
                                                     ((False, 2), None)]


def test_calc_metrics_cli_data_parallel_on_cpu(gens, tmp_path, mesh_spy,  # noqa: F811,E501
                                               monkeypatch):
    from stylemc_torch.cli import calc_metrics as tcli

    _, _, tcfg, tgp = gens
    net = str(tmp_path / "net.npz")
    save_native(net, tcfg, tgp)
    monkeypatch.delenv("STYLEMC_INCEPTION", raising=False)
    monkeypatch.delenv("STYLEMC_LPIPS_VGG", raising=False)
    lines = []
    for flag in (["--data_parallel"], []):
        r = CliRunner().invoke(tcli.main, [
            "--network", net, "--metrics", "is50k,ppl2_wend", "--num_gen",
            "2", "--batch", "2", "--allow_random_init", "--detector_variant",
            "tv", "--device", "cpu"] + flag, catch_exceptions=False)
        assert r.exit_code == 0, r.output
        lines.append([{k: v for k, v in json.loads(x).items()
                       if k != "total_time"} for x in r.output.splitlines()
                      if x.startswith("{")])
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert [(a, o) for _, a, o in mesh_spy] == [((True, 2), None),
                                                     ((False, 2), None)]


def test_train_e4e_cli_data_parallel_on_cpu(files, tiny_clis,  # noqa: F811
                                            tmp_path, mesh_spy):
    from stylemc_torch.cli import train_e4e as ttrain_cli
    from stylemc_torch.io.numpy_pickle import load_numpy_pickle

    states = []
    for flag in (["--data_parallel"], []):
        out = tmp_path / f"e4e{len(flag)}"
        r = CliRunner().invoke(ttrain_cli.main, [
            "--exp_dir", str(out), "--source_root", files["photos"],
            "--stylegan_weights", files["pkl"], "--stylegan_size", "256",
            "--batch_size", "2", "--max_steps", "2", "--board_interval", "1",
            "--device", "cpu"] + flag, catch_exceptions=False)
        assert r.exit_code == 0, r.output
        states.append(load_numpy_pickle(str(out / "checkpoints" /
                                            "last.pkl")))
    a, b = (_paths(s["encoder_params"]) for s in states)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert tiny_clis["torch"][:2] == tiny_clis["torch"][2:]
    assert [(a, o) for _, a, o in mesh_spy] == [((True, 2), None),
                                                     ((False, 2), None)]


def test_serve_cli_data_parallel_on_cpu(tmp_path, mesh_spy, monkeypatch):
    from stylemc_torch.cli import serve as tserve
    from stylemc_torch.models.stylegan2.generator import (
        GeneratorConfig, init_generator_params)
    from stylemc_torch.serve import BatchEditor

    cfg = GeneratorConfig(img_resolution=32, channel_base=1024,
                          channel_max=64, mapping_layers=2)
    net = str(tmp_path / "net.npz")
    save_native(net, cfg, init_generator_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    d = str(tmp_path / "d.npz")
    np.savez(d, s=np.full((1, 26, 512), 0.1, np.float32))
    editors = []

    class Server:
        def serve_forever(self):
            pass

    monkeypatch.setattr(tserve, "build_server", lambda editor, *a, **kw: (
        editors.append(editor) or Server(), None))
    for flag in (["--data_parallel"], []):
        r = CliRunner().invoke(tserve.main, [
            "--network", net, "--direction", d, "--max_batch", "4",
            "--no-warmup", "--device", "cpu"] + flag, catch_exceptions=False)
        assert r.exit_code == 0, r.output
    assert [e.mesh for e in editors] == [None, None]
    a, b = (e.edit_seeds([1, 2, 3], change_power=1.0) for e in editors)
    np.testing.assert_array_equal(a, b)
    assert [(a, o) for _, a, o in mesh_spy] == [((True, 4), None),
                                                     ((False, 4), None)]
    assert isinstance(editors[0], BatchEditor)
