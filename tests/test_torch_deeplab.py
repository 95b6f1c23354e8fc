"""The port's DeepLab face parser and feature blending against the JAX
package's, on the CPU (fp32), with JAX's initialiser's weights carried
across.

Tolerances: logits 1e-4; the checkpoint conversion exact; class maps and
masks equal; INTER_AREA resizes exact; blended renders ±1 per uint8;
run_deeplab's PNGs equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from stylemc_tpu import edit as jedit
from stylemc_tpu.models import deeplab as jdl
from stylemc_tpu.models.stylegan2.generator import init_generator_params
from stylemc_torch import edit as tedit
from stylemc_torch.convert import params_from_numpy
from stylemc_torch.models import deeplab as tdl
from stylemc_torch.models.stylegan2.generator import GeneratorConfig
from tiny import tiny_gen
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(layers=(1, 1, 1, 1), width=16)


@pytest.fixture(scope="module")
def small():
    """(JAX params, the JAX Segmenter's logits function) of a reduced
    network: one block a stage, width 16."""
    params = jdl.init_deeplab_params(jax.random.PRNGKey(0), **SMALL)
    return params, jax.jit(jdl.deeplab_apply)


def _image(seed=0, size=64):
    """A seeded uint8 face-sized image: smooth blobs plus noise, so the
    parser's logits vary across it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([np.sin(6 * xx + c) * np.cos(4 * yy - c)
                    for c in (0.0, 1.0, 2.0)], -1) * 100 + 128
    img += rng.randn(size, size, 3) * 20
    return np.clip(img, 0, 255).astype(np.uint8)


def test_deeplab_apply_matches_jax(small):
    params, japply = small
    x = np.random.RandomState(1).randn(2, 3, 65, 65).astype(np.float32)
    want = np.asarray(japply(params, jnp.asarray(x)))
    got = tdl.deeplab_apply(params_from_numpy(params, "cpu"),
                            torch.from_numpy(x)).numpy()
    assert got.shape == (2, 19, 65, 65)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the weight standardisation uses the unbiased std, as torch.std does
    w = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 3, 3)
                         .astype(np.float32))
    xs = torch.from_numpy(np.random.RandomState(3).randn(1, 3, 8, 8)
                          .astype(np.float32))
    ws = (w - w.mean(dim=(1, 2, 3), keepdim=True)) / (
        w.std(dim=(1, 2, 3), keepdim=True) + 1e-5)
    torch.testing.assert_close(tdl._ws_conv(xs, w),
                               torch.nn.functional.conv2d(xs, ws),
                               rtol=1e-5, atol=1e-5)


def test_checkpoint_layout_round_trips(small, tmp_path):
    """params_from_torch_state strips 'module.' and drops the
    'num_batches_tracked' entries; at full ResNet-101 depth it reads what
    JAX's reads, and a reduced checkpoint loads by its own depths."""
    params, _ = small
    state = tdl.params_to_torch_state(params)
    prefixed = {f"module.{k}": v for k, v in state.items()}
    prefixed["module.bn1.num_batches_tracked"] = np.zeros((), np.int64)
    prefixed["module.layer1.0.bn1.num_batches_tracked"] = np.ones((),
                                                                  np.int64)
    back = tdl.params_from_torch_state(prefixed)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, np.asarray(b))

    full = tdl.init_deeplab_params(torch.Generator().manual_seed(0))
    full_state = tdl.params_to_torch_state(full)
    jfull = jdl.params_from_torch_state(full_state)
    tfull = tdl.params_from_torch_state(full_state)
    assert [len(tfull[f"layer{i}"]) for i in range(1, 5)] == \
        list(tdl.RESNET101_LAYERS)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(tfull),
                                jax.tree_util.tree_leaves_with_path(jfull)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tfull["aspp"]["conv3_weight"].shape == (19, 256, 1, 1)

    # the writer: the reference's {'state_dict': {'module.' + name}} file,
    # read back by default_segmenter through STYLEMC_DEEPLAB
    ckpt = str(tmp_path / "deeplab_model.pth")
    tdl.save_deeplab_checkpoint(ckpt, params)
    sd = torch.load(ckpt, weights_only=True)["state_dict"]
    assert all(k.startswith("module.") for k in sd)
    os.environ["STYLEMC_DEEPLAB"] = ckpt
    try:
        seg = tdl.default_segmenter(resolution=32, device="cpu")
    finally:
        del os.environ["STYLEMC_DEEPLAB"]
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(
                {k: v for k, v in seg.params.items()}),
            jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(FileNotFoundError, match="STYLEMC_DEEPLAB"):
        tdl.default_segmenter(str(tmp_path / "missing.pth"), device="cpu")


def test_segmenter_and_masks_match_jax(small):
    params, japply = small
    jseg = jdl.Segmenter(params, resolution=64)
    tseg = tdl.Segmenter(params, resolution=64, device="cpu")
    img = _image()
    # the 513² logits, and the pixels NEAREST samples for 64²
    x = tdl.preprocess(img)
    want = np.asarray(japply(params, jnp.asarray(x)))[0]
    got = tseg.logits(img)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    idx = np.asarray(Image.fromarray(
        np.arange(513 * 513, dtype=np.int32).reshape(513, 513)).resize(
            (64, 64), Image.NEAREST)).ravel()
    assert len(set(want.argmax(0).ravel()[idx])) > 2  # several classes

    np.testing.assert_array_equal(tseg.segment(img), jseg.segment(img))
    np.testing.assert_array_equal(tseg.get_bg_mask(img),
                                  jseg.get_bg_mask(img))
    for need in (True, False):
        for a, b in zip(tseg.get_earring_mouth_teeth_masks(img, need),
                        jseg.get_earring_mouth_teeth_masks(img, need)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    assert tdl.CLASSES == jdl.CLASSES


def test_resize_mask_area_and_read_image_mask(tmp_path):
    mask = np.random.RandomState(4).rand(64, 64) > 0.5
    for res in (32, 64, 16):
        got = tedit.resize_mask_area(mask, res)
        np.testing.assert_array_equal(got, jedit.resize_mask_area(mask, res))
        assert got.dtype == np.float64 and got.shape == (res, res)
    parsing = np.random.RandomState(5).randint(0, 19, (64, 64)).astype(
        np.uint8)
    path = str(tmp_path / "p.png")
    Image.fromarray(parsing).save(path)
    for kw in ({}, {"mask_min_value": 0.3, "dilation": False}):
        np.testing.assert_array_equal(tdl.read_image_mask(path, **kw),
                                      jdl.read_image_mask(path, **kw))


class _StubSegmenter:
    """Fixed masks: the blending path without a face parser."""

    def __init__(self, size=64):
        rng = np.random.RandomState(7)
        self.bg = rng.rand(size, size) > 0.6
        self.masks = [rng.rand(size, size) > 0.7 for _ in range(3)]

    def get_bg_mask(self, img_u8):
        assert img_u8.dtype == np.uint8 and img_u8.ndim == 3
        return self.bg

    def get_earring_mouth_teeth_masks(self, img_u8, need_earring_mask=True):
        earring, mouth, teeth = self.masks
        return (earring if need_earring_mask else None), mouth, teeth


@pytest.mark.parametrize("prompt,second_generator", [
    ("a smiling face", False), ("a smiling face", True),
    ("a face of a man", False)])
def test_blending_matches_jax(prompt, second_generator):
    """A 64 px generator has both blend resolutions (32² earring, 64²
    background and teeth); with 'face of a man' no earring mask; a second
    generator renders the edits."""
    gen_cfg, gen_params = tiny_gen(resolution=64)
    p2 = init_generator_params(jax.random.PRNGKey(3), gen_cfg) \
        if second_generator else None
    tcfg = GeneratorConfig(img_resolution=64, channel_base=2048,
                           channel_max=64, mapping_layers=2)
    from stylemc_tpu.models.stylegan2.generator import mapping, w_to_s
    z = jax.random.normal(jax.random.PRNGKey(2), (1, gen_cfg.z_dim))
    styles = np.asarray(w_to_s(gen_params, gen_cfg,
                               mapping(gen_params, gen_cfg, z)))[0]
    d = np.zeros((1, 26, 512), np.float32)
    d[:, [2, 5, 8, 11], :64] = 0.3
    stub = _StubSegmenter()
    gen2 = p2 if second_generator else None
    want = jedit.apply_edit_item_with_blending(
        gen_params, gen_cfg, jnp.asarray(styles), jnp.asarray(d), 1.5,
        stub, text_prompt=prompt,
        gen2=None if gen2 is None else (gen2, gen_cfg))
    got = tedit.apply_edit_item_with_blending(
        params_from_numpy(gen_params, "cpu"), tcfg,
        torch.from_numpy(styles), torch.from_numpy(d), 1.5, stub,
        text_prompt=prompt,
        gen2=None if gen2 is None else (params_from_numpy(gen2, "cpu"),
                                        tcfg))
    for a, b in zip(got, want):
        assert a.shape == (64, 64, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1
    # blending moves the edit toward the original where the masks are set
    _, plain = tedit.apply_edit_batch(
        params_from_numpy(gen_params, "cpu"), tcfg,
        torch.from_numpy(styles[None]), torch.from_numpy(d), 1.5,
        gen2=None if gen2 is None else (params_from_numpy(gen2, "cpu"),
                                        tcfg))
    assert np.abs(tedit.to_uint8_hwc(plain)[0].astype(int)
                  - got[1].astype(int)).max() > 0


def test_run_deeplab_writes_jax_segmenter_pngs(small, tmp_path):
    from stylemc_torch.cli.run_deeplab import main

    params, _ = small
    root = tmp_path / "imgs"
    os.makedirs(root)
    for i in range(2):
        Image.fromarray(_image(seed=10 + i)).save(root / f"im{i}.jpg")
    ckpt = str(tmp_path / "deeplab_model.pth")
    tdl.save_deeplab_checkpoint(ckpt, params)
    r = CliRunner().invoke(main, ["--dataset_root", str(root), "--ckpt", ckpt,
                                  "--resolution", "48", "--device", "cpu"],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    assert "saved 2 parsings" in r.output
    jseg = jdl.Segmenter(params, resolution=48)
    for i in range(2):
        got = np.asarray(Image.open(root / "parsings" / f"im{i}.png"))
        img = np.asarray(Image.open(root / f"im{i}.jpg").convert("RGB"))
        assert got.shape == (48, 48) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jseg.segment(img))
