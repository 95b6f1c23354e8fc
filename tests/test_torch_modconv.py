"""B3/B4/B5, the fused synthesis layer, on the CPU.

`fused_modulated_layer` of the port (whose wrapper runs the kernels' plain
versions for CPU tensors) is held against the JAX package's
`fused_modulated_layer` (the Pallas kernels in interpret mode, mxu
'highest', force=True) at the JAX tests' tolerances: forward rtol/atol
2e-5 (2e-3 absolute where the clamp binds: reassociation moves values at
±256 by a few ulps), gradients rtol 5e-4 with atol 5e-4·max|ref|. Each
plain backward alone is held against the private Pallas call it replaces
(`_bwd_data_call`, `_bwd_weight_call`) at rtol 1e-5, atol 1e-5·max|ref|:
each output is a sum of 2k–4k products, whose cancellation leaves some
entries far smaller than the terms (fp32 summation order differs). The
shapes the JAX layer declines (W % 128 != 0, 4x4) are held against its
unfused `modulated_conv2d` + `bias_act`. On the card the same Function
launches the kernels (`test_modconv_kernels_match_plain_on_cuda` in
test_torch_isolation.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemc_tpu.models.stylegan2 import generator as jgen
from stylemc_tpu.ops import bias_act as jbias_act
from stylemc_tpu.ops.modulated_conv import modulated_conv2d as jmodconv
from stylemc_tpu.ops.pallas import modconv_pallas as jmc
from stylemc_torch.bench import fused_layer_ab
from stylemc_torch.ops.kernels import modconv
from torch_threads import one_torch_thread  # noqa: F401

GAIN = float(np.sqrt(2))


def _mk(n=2, ci=8, co=16, h=16, w_sp=128, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, ci, h, w_sp).astype(np.float32)
    w = (rs.randn(co, ci, 3, 3) * 0.3).astype(np.float32)
    s = (rs.randn(n, ci) * 0.7 + 1.0).astype(np.float32)
    noise = (rs.randn(h, w_sp) * 0.1).astype(np.float32)
    b = (rs.randn(co) * 0.2).astype(np.float32)
    return x, w, s, noise, b


def _clamped(seed=3):
    x, w, s, noise, b = _mk(seed=seed)
    return x * 600.0, w, s, noise, b


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_fused(x, w, s, noise, b):
    return jmc.fused_modulated_layer(x, w, s, noise, b, gain=GAIN,
                                     clamp=256.0, mxu="highest", force=True)


def _jax_unfused(x, w, s, noise, b):
    y = jmodconv(x, w, s, noise=noise[None, None], up=1, padding=1,
                 flip_weight=True)
    return jbias_act(y, b, act="lrelu", gain=GAIN, clamp=256.0)


def _port(x, w, s, noise, b):
    return modconv.fused_modulated_layer(x, w, s, noise, b, gain=GAIN,
                                         clamp=256.0, mxu="highest")


@pytest.mark.parametrize("case,atol", [
    (lambda: _mk(), 2e-5),
    (_clamped, 2e-3),
    (lambda: _mk(n=3, ci=16, co=8, h=24, w_sp=128, seed=7), 2e-5),
], ids=["mk", "clamp_binds", "odd_batch_tall"])
def test_forward_matches_jax_fused(case, atol):
    arrays = case()
    want = np.asarray(_jax_fused(*map(jnp.asarray, arrays)))
    if atol > 2e-5:
        assert (np.abs(want) >= 256.0 - 1e-3).any(), "clamp never bound"
    got = _port(*_t(*arrays))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=atol)


def _grads_close(got, want, names):
    for name, g, a in zip(names, got, want):
        a = np.asarray(a)
        scale = max(1e-6, float(np.abs(a).max()))
        np.testing.assert_allclose(g.numpy(), a, rtol=5e-4,
                                   atol=5e-4 * scale, err_msg=name)


def _port_grads(layer, x, w, s, noise, b):
    leaves = [t.clone().requires_grad_(True) for t in _t(x, w, s, b)]
    y = layer(leaves[0], leaves[1], leaves[2], torch.from_numpy(noise),
              leaves[3])
    return torch.autograd.grad(torch.sum(y ** 2), leaves)


@pytest.mark.parametrize("case", [_mk, _clamped], ids=["mk", "clamp_active"])
def test_grads_match_jax_fused(case):
    x, w, s, noise, b = case()

    def loss(x, w, s, b):
        return jnp.sum(jnp.square(_jax_fused(x, w, s, jnp.asarray(noise), b)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, s, b)))
    got = _port_grads(_port, x, w, s, noise, b)
    _grads_close(got, want, ("dx", "dw", "ds", "db"))


def _close_scaled(got, want, name, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


def _pallas_bwd_inputs(x, w, s, noise, b, seed=11):
    """The JAX forward's y and d at these inputs, a cotangent, and the
    Pallas backward calls' flat layouts of them (as `_fused_layer_bwd`)."""
    n, ci, h, w_sp = x.shape
    jx, jw, js, jnoise, jb = map(jnp.asarray, (x, w, s, noise, b))
    y, res = jmc._fused_layer_fwd(jx, jw, js, jnoise, jb, h, GAIN, 256.0,
                                  "highest")
    d = res[-1]
    dy = jnp.asarray(np.random.RandomState(seed).randn(*y.shape)
                     .astype(np.float32))
    flat = {"dyf": jmc._rowpad_flat(dy, h, w_sp),
            "yf": jmc._rowpad_flat(y, h, w_sp),
            "noise_f": jnoise.reshape(1, h * w_sp)}
    return dy, y, d, flat


@pytest.mark.parametrize("case", [_mk, _clamped], ids=["mk", "clamp_active"])
def test_bwd_data_plain_matches_pallas_call(case):
    x, w, s, noise, b = case()
    n, ci, h, w_sp = x.shape
    dy, y, d, flat = _pallas_bwd_inputs(x, w, s, noise, b)
    _, wt = jmc._prep(jnp.asarray(w))
    dxf, ds, dd, db, _ = jmc._bwd_data_call(
        flat["dyf"], flat["yf"], jnp.asarray(x).reshape(n, ci, h * w_sp), wt,
        jnp.asarray(s), d, flat["noise_f"], jnp.asarray(b).reshape(-1, 1), h,
        GAIN, 256.0, jnp.float32)
    want = (np.asarray(dxf).reshape(x.shape), np.asarray(ds)[:, :, 0],
            np.asarray(dd)[:, :, 0], np.asarray(db)[:, :, 0])
    got = modconv.fused_layer_bwd_data_plain(
        *_t(dy, y, x, w, s, d, noise, b), GAIN, 256.0)
    for name, g, a in zip(("dx", "ds_direct", "dd", "db"), got, want):
        _close_scaled(g, a, name)


@pytest.mark.parametrize("case", [_mk, _clamped], ids=["mk", "clamp_active"])
def test_bwd_weight_plain_matches_pallas_call(case):
    x, w, s, noise, b = case()
    n, ci, h, w_sp = x.shape
    co = w.shape[0]
    dy, y, d, flat = _pallas_bwd_inputs(x, w, s, noise, b)
    taps = jmc._bwd_weight_call(
        flat["dyf"], flat["yf"], jmc._rowpad_flat(jnp.asarray(x), h, w_sp),
        jnp.asarray(s), d, h, GAIN, 256.0, ci, jnp.float32)
    want = np.transpose(np.asarray(taps).reshape(3, 3, co, ci), (2, 3, 0, 1))
    got = modconv.fused_layer_bwd_weight_plain(*_t(dy, y, x, s, d), GAIN,
                                               256.0)
    _close_scaled(got, want, "dw")


def test_declines_as_jax_does():
    x, w, s, noise, b = _t(*_mk())
    w5 = torch.zeros((16, 8, 5, 5))
    assert modconv.fused_modulated_layer(x, w5, s, noise, b) is None
    assert modconv.fused_modulated_layer(x, w, s, None, b) is None
    assert modconv.fused_modulated_layer(x, w, s, noise[None], b) is None
    per_sample = noise[None, None].repeat(2, 1, 1, 1)
    assert modconv.fused_modulated_layer(x, w, s, per_sample, b) is None
    assert modconv.fused_modulated_layer(x, w, s, noise, b,
                                         noise_grad=True) is None
    # the JAX layer declines these inputs the same way
    jx, jw, js, jnoise, jb = map(jnp.asarray, _mk())
    assert jmc.fused_modulated_layer(jx, jw, js, jnoise, jb, force=True,
                                     noise_grad=True) is None
    assert jmc.fused_modulated_layer(jx, jw, js, jnp.broadcast_to(
        jnoise, (2, 1) + jnoise.shape), jb, force=True) is None
    # [1,1,H,W] noise is broadcast like [H,W]
    torch.testing.assert_close(
        modconv.fused_modulated_layer(x, w, s, noise[None, None], b),
        modconv.fused_modulated_layer(x, w, s, noise, b), rtol=0, atol=0)


def _bf16_step(v):
    """The spacing of bfloat16 values (8 significant bits) at |v|."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def test_rejects_bf16_and_unknown_mxu():
    """A bf16 x computes as the JAX fused layer does (interpret mode, mxu
    'highest'): in float32, y and dx in bf16, dw, ds and db in their inputs'
    float32. Tolerances: y and dx within one bf16 step of JAX's elementwise
    (the fp32 values agree to ~1e-7 and each side rounds them to bf16);
    db within 1e-5·max|ref|, as it needs no y; dw and ds within
    2^-8·max|ref|, one bf16 relative step: JAX's backward rebuilds z1 from
    its bf16 y for dd, and dw and ds carry dd. An integer x and an unknown
    `mxu` are refused."""
    x, w, s, noise, b = _mk()
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def jax_loss(x, w, s, b):
        y = _jax_fused(x, w, s, jnp.asarray(noise), b)
        return jnp.sum(jnp.square(y.astype(jnp.float32))), y

    (_, want_y), want = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jx, *map(jnp.asarray, (w, s, b)))
    leaves = [torch.from_numpy(np.array(jx.astype(jnp.float32)))
              .bfloat16().requires_grad_(True)]
    leaves += [t.requires_grad_(True) for t in _t(w, s, b)]
    y = _port(leaves[0], leaves[1], leaves[2], torch.from_numpy(noise),
              leaves[3])
    got = torch.autograd.grad(torch.sum(y.float() ** 2), leaves)
    assert y.dtype == torch.bfloat16 and want_y.dtype == jnp.bfloat16
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 3
    for name, g, a in (("y", y, want_y), ("dx", got[0], want[0])):
        a = np.asarray(a.astype(jnp.float32))
        err = np.abs(g.detach().float().numpy() - a)
        assert (err <= _bf16_step(a)).all(), name
    for name, g, a, tol in zip(("dw", "ds", "db"), got[1:], want[1:],
                               (2.0 ** -8, 2.0 ** -8, 1e-5)):
        _close_scaled(g, np.asarray(a), name, tol)

    x, w, s, noise, b = _t(*_mk())
    with pytest.raises(TypeError, match="floating"):
        modconv.fused_modulated_layer(x.to(torch.int32), w, s, noise, b)
    with pytest.raises(ValueError, match="mxu"):
        modconv.fused_modulated_layer(x, w, s, noise, b, mxu="bf16x3")
    # "default" and "highest" compute the same fp32 function here
    torch.testing.assert_close(
        modconv.fused_modulated_layer(x, w, s, noise, b, mxu="default"),
        modconv.fused_modulated_layer(x, w, s, noise, b, mxu="highest"),
        rtol=0, atol=0)


def test_noise_cotangent_is_zero():
    x, w, s, noise, b = _t(*_mk())
    noise = noise.clone().requires_grad_(True)
    y = modconv.fused_modulated_layer(x, w, s, noise, b)
    g, = torch.autograd.grad(y.sum(), noise)
    assert torch.count_nonzero(g) == 0 and g.shape == noise.shape


# W = 96 is not lane-aligned and 4x4 is below the JAX layer's 8-row floor:
# the JAX fused layer declines both; the port runs them (4x4 is b4's conv1)
@pytest.mark.parametrize("shape", [dict(n=2, ci=8, co=16, h=16, w_sp=96),
                                   dict(n=3, ci=16, co=16, h=4, w_sp=4)],
                         ids=["w96", "b4_4x4"])
def test_shapes_jax_declines_match_jax_unfused(shape):
    x, w, s, noise, b = _mk(seed=5, **shape)
    jargs = list(map(jnp.asarray, (x, w, s, noise, b)))
    assert jmc.fused_modulated_layer(*jargs, force=True) is None
    want = np.asarray(_jax_unfused(*jargs))
    got = _port(*_t(x, w, s, noise, b))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    def loss(x, w, s, b):
        return jnp.sum(jnp.square(_jax_unfused(x, w, s, jnp.asarray(noise),
                                               b)))

    want_g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, s, b)))
    _grads_close(_port_grads(_port, x, w, s, noise, b), want_g,
                 ("dx", "dw", "ds", "db"))


def test_frozen_weight_never_runs_the_weight_gradient(monkeypatch):
    calls = []
    real = modconv.fused_layer_bwd_weight_plain

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(modconv, "fused_layer_bwd_weight_plain", spy)
    x, w, s, noise, b = _t(*_mk())
    xs = [x.clone().requires_grad_(True), s.clone().requires_grad_(True)]
    y = modconv.fused_modulated_layer(xs[0], w, xs[1], noise, b)
    dx, ds = torch.autograd.grad(y.sum(), xs)
    assert not calls and dx.shape == x.shape and ds.shape == s.shape
    wg = w.clone().requires_grad_(True)
    y = modconv.fused_modulated_layer(x, wg, s, noise, b)
    dw, = torch.autograd.grad(y.sum(), wg)
    assert len(calls) == 1 and dw.shape == w.shape


def test_ab_layers_are_the_full_width_generators_conv1s():
    """The A/B's table is every conv1 of the JAX package's full-width
    FFHQ-256 generator (its parameter shapes, traced without allocating)."""
    cfg = jgen.GeneratorConfig(img_resolution=256)
    shapes = jax.eval_shape(
        lambda k: jgen.init_generator_params(k, cfg), jax.random.PRNGKey(0))
    want = []
    for res in cfg.block_resolutions:
        lp = shapes["synthesis"][f"b{res}"]["conv1"]
        co, ci, kh, kw = lp["weight"].shape
        assert (ci, kh, kw) == (co, 3, 3)
        assert lp["noise_const"].shape == (res, res)
        want.append((co, res))
    assert fused_layer_ab.layer_shapes() == want
    assert want == [(512, 4), (512, 8), (512, 16), (512, 32), (512, 64),
                    (256, 128), (128, 256)]
    # 2·N·C²·9·H·W over the seven layers at batch 4 and 16
    flop = [sum(fused_layer_ab.layer_flop(c, r, n) for c, r in want)
            for n in (4, 16)]
    assert flop == [257_597_374_464, 4 * 257_597_374_464]


@pytest.mark.parametrize("mode", fused_layer_ab.MODES,
                         ids=[m.name for m in fused_layer_ab.MODES])
def test_ab_step_fused_matches_unfused(mode):
    """Each A/B mode computes the same outputs and gradients through the
    fused and the unfused layer (CPU, a narrow layer at the mode's batch)."""
    inputs = fused_layer_ab.make_inputs(mode.batch, 8, 8, 8, 8, "cpu",
                                        seed=4)
    cot = torch.randn((mode.batch, 8, 8, 8),
                      generator=torch.Generator().manual_seed(5))
    fused = fused_layer_ab.step(fused_layer_ab.fused_layer, inputs, mode, cot)
    unfused = fused_layer_ab.step(fused_layer_ab.unfused_layer, inputs, mode,
                                  cot)
    assert len(fused) == len(unfused) == 1 + len(mode.grads)
    assert not fused_layer_ab.activation_flips(fused[0], unfused[0]).any()
    for f, u in zip(fused, unfused):
        torch.testing.assert_close(f, u, rtol=1e-5, atol=1e-5)
