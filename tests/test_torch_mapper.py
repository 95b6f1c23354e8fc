"""The port's latent mapper and mapper directions against the JAX package's,
on the CPU (fp32), with JAX's initialiser's weights carried across through
the reference state dict.

Tolerances: mapper outputs 1e-5 and their input gradient 1e-5 of its
largest value; directions 1e-6 of their largest value (|δ| reaches ~4),
the stoplist's entries exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemc_tpu import edit as jedit
from stylemc_tpu.io import load_state_dict_numpy as jax_load_state
from stylemc_tpu.models import mapper as jmap
from stylemc_torch import edit as tedit
from stylemc_torch.models import mapper as tmap
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's Mapper on the CPU) of the same weights, the
    biases made non-zero so they take part."""
    jp = jmap.init_mapper_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    for part in tmap.PARTS:
        for i in range(tmap.N_MODULES):
            jp[part][f"mod{i}"]["fc"]["bias"] = jnp.asarray(
                rng.randn(512).astype(np.float32) * 0.05)
    return jp, tmap.params_from_torch_state(jmap.params_to_torch_state(jp),
                                            "cpu")


def _styles(n, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(n, 26, 512) * scale
            ).astype(np.float32)


def test_mapper_apply_and_input_gradient_match_jax(weights):
    jp, mapper = weights
    x = _styles(3)[:, :8]
    cot = np.random.RandomState(1).randn(3, 8, 512).astype(np.float32)
    for slope in (0.01, 0.2):
        want = jmap.mapper_apply(jp, jnp.asarray(x), slope)
        jg = jax.grad(lambda v: jnp.sum(
            jmap.mapper_apply(jp, v, slope) * cot))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = tmap.mapper_apply(mapper, xt, slope)
        tg, = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), xt)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        # the gradient runs through five LayerNorms and reaches |g| ~ 5:
        # 1e-5 of its largest value
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())
        torch.testing.assert_close(mapper(torch.from_numpy(x), slope),
                                   got.detach(), rtol=0, atol=0)


def test_coarse_and_medium_halves_are_independent(weights):
    _, mapper = weights
    x = torch.from_numpy(_styles(2)[:, :8])
    base = tmap.mapper_apply(mapper, x).detach()
    for rows, other in ((slice(0, 4), slice(4, 8)), (slice(4, 8),
                                                     slice(0, 4))):
        y = x.clone()
        y[:, rows] += 1.0
        out = tmap.mapper_apply(mapper, y).detach()
        torch.testing.assert_close(out[:, other], base[:, other], rtol=0,
                                   atol=0)
        assert (out[:, rows] - base[:, rows]).abs().max() > 1e-3


def test_pixel_norm_runs_over_the_layer_axis():
    """The reference's PixelNorm normalises over dim 1, which for the
    mapper's [N, 4, 512] input is the layer axis: on an input whose rows
    have different scales, that differs from a norm over the channels."""
    x = _styles(2)[:, :4] * np.asarray([1, 3, 0.2, 7],
                                       np.float32)[None, :, None]
    got = tmap.pixel_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmap.pixel_norm(
        jnp.asarray(x))), rtol=0, atol=1e-6)
    want = x / np.sqrt(np.mean(x.astype(np.float64) ** 2, axis=1,
                               keepdims=True) + 1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    channel = x / np.sqrt(np.mean(x ** 2, axis=2, keepdims=True) + 1e-8)
    assert np.abs(got - channel).max() > 0.1


def test_init_is_seeded_uniform_with_zero_bias():
    state = torch.get_rng_state()
    a = tmap.init_mapper_params(torch.Generator().manual_seed(0),
                                device="cpu")
    b = tmap.init_mapper_params(torch.Generator().manual_seed(0),
                                device="cpu")
    assert torch.equal(state, torch.get_rng_state())  # global RNG untouched
    sa, sb = tmap.params_to_torch_state(a), tmap.params_to_torch_state(b)
    assert sorted(sa) == sorted(jmap.params_to_torch_state(
        jmap.init_mapper_params(jax.random.PRNGKey(0))))
    assert len(sa) == 20
    for k, v in sa.items():
        np.testing.assert_array_equal(v, sb[k])
        if k.endswith("bias"):
            assert not v.any()
        else:
            assert v.shape == (512, 512)
            assert np.abs(v).max() <= 1 / np.sqrt(512)
            assert np.abs(v).max() > 0.9 / np.sqrt(512)
    if not torch.cuda.is_available():  # the card unless asked otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmap.init_mapper_params(torch.Generator())


def test_state_dict_round_trips_through_both_packages(weights, tmp_path):
    jp, mapper = weights
    x = _styles(2, seed=7)[:, :8]
    want = tmap.mapper_apply(mapper, torch.from_numpy(x)).detach().numpy()
    # the port writes, JAX reads
    path = str(tmp_path / "mapper_a_face.pth")
    tmap.save_mapper(mapper, path)
    sd = torch.load(path, weights_only=True)
    assert "course_mapping.modulation_module_list.0.fc.weight" in sd
    assert all(v.device.type == "cpu" for v in sd.values())
    back = jmap.params_from_torch_state(jax_load_state(path))
    np.testing.assert_allclose(
        np.asarray(jmap.mapper_apply(back, jnp.asarray(x))), want, rtol=0,
        atol=1e-5)
    # JAX writes (its CLI's save), the port reads
    path2 = str(tmp_path / "mapper_jax.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                jmap.params_to_torch_state(jp).items()}, path2)
    got = tmap.load_mapper(path2, device="cpu")
    np.testing.assert_allclose(
        tmap.mapper_apply(got, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmap.mapper_apply(jp, jnp.asarray(x))), rtol=0, atol=1e-5)
    # and a plain load_state_dict of a reference-named file
    fresh = tmap.Mapper()
    fresh.load_state_dict(torch.load(path2, weights_only=True))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, got.state_dict()[k], rtol=0, atol=0)


def test_whitelist_and_stoplist_ids_match_jax():
    assert tedit.WHITELIST_S_IDS == jedit.WHITELIST_S_IDS
    assert tedit.STOPLIST_S_IDS == jedit.STOPLIST_S_IDS
    assert tedit.TRAINABLE == jedit.TRAINABLE


@pytest.mark.parametrize("use_whitelist", [False, True])
def test_mapper_directions_match_jax(weights, use_whitelist):
    jp, mapper = weights
    styles = _styles(3, seed=11)
    want = np.asarray(jedit.mapper_directions_batched(
        jp, jnp.asarray(styles), neg_slope=0.05,
        use_whitelist=use_whitelist))
    got = tedit.mapper_directions_batched(
        mapper, torch.from_numpy(styles), neg_slope=0.05,
        use_whitelist=use_whitelist).numpy()
    assert got.shape == (3, 26, 512)
    # five fp32 layers leave ~3e-6 on outputs up to ~4: 1e-6 of the largest
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if not use_whitelist:  # the trainable rows are the mapper's output
        torch.testing.assert_close(
            torch.from_numpy(got[:, tedit.TRAINABLE]),
            tmap.mapper_apply(mapper, torch.from_numpy(
                styles[:, tedit.TRAINABLE]), 0.05).detach(), rtol=0, atol=0)
    frozen = [r for r in range(26) if r not in tedit.TRAINABLE]
    assert not got[:, frozen].any()
    flat = got.reshape(3, -1)
    if use_whitelist:
        assert not flat[:, tedit.STOPLIST_S_IDS].any()
        live = got[:, tedit.TRAINABLE]
        assert np.all((live == 0) | (np.abs(live) >= 0.1))
        assert (live == 0).any() and (live != 0).any()
    else:
        assert flat[:, tedit.STOPLIST_S_IDS].any()
    one = tedit.mapper_direction(mapper, torch.from_numpy(styles[1]),
                                 neg_slope=0.05, use_whitelist=use_whitelist)
    jone = jedit.mapper_direction(jp, jnp.asarray(styles[1]), neg_slope=0.05,
                                  use_whitelist=use_whitelist)
    assert one.shape == (1, 26, 512)
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), rtol=0,
                               atol=1e-6 * np.abs(want).max())
