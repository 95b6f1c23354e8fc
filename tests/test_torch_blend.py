"""The port's batched DeepLab feature blending against the benchmark's
plain PyTorch reference (`benchmark/reference/deeplab.py`,
`benchmark/reference/blending.py`), on the CPU in fp32, at small widths
with seeded random weights: a one-block-a-stage ResNet at width 32 and a
64 px generator, which has both blend resolutions (32² and 64²).

Tolerances: logits 1e-5·max|logit|; masks equal on the same class map,
and on the same renders (each side parsing them itself, where rounding
can flip an argmax at a near tie) apart in at most 1e-3 of their pixels;
blended renders uint8 ±1 against the reference's per-item blending from
the port's masks; the batched path equal to its one-item case, row by
row.
"""

import io

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from benchmark.core import weights
from benchmark.reference import blending as rblend
from benchmark.reference import deeplab as rdl
from benchmark.reference import stylegan2 as rsg
from stylemc_torch.edit import (apply_edit_item_with_blending,
                                needs_earring_mask)
from stylemc_torch.models import deeplab as dl
from stylemc_torch.models.stylegan2.generator import (GeneratorConfig,
                                                      mapping, w_to_s)
from stylemc_torch.serve import BatchEditor
from torch_threads import one_torch_thread  # noqa: F401

G = {"z_dim": 512, "w_dim": 512, "img_resolution": 64, "img_channels": 3,
     "channel_base": 2048, "channel_max": 64, "mapping_layers": 2,
     "mapping_lr_multiplier": 0.01, "conv_clamp": 256.0,
     "resample_filter": [1, 3, 3, 1], "torgb_scale": 0.125, "bias_std": 0.1,
     "noise_strength_std": 0.05}
CFG = GeneratorConfig(img_resolution=64, channel_base=2048, channel_max=64,
                      mapping_layers=2, num_fp16_res=0)
# background and cloth favoured, so that the eroded background mask holds
# a third of the picture beside small earring and teeth masks
BIAS = {"background": 2.0, "cloth": 2.0}
SMILE, MAN = "a smiling face", "a face of a man with a beard"


class Kept(dl.Segmenter):
    """The port's Segmenter, keeping what each `blend_masks` call was
    given (functions that return the renders) and gave."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = []

    def blend_masks(self, originals_u8, edits_u8, need_earring):
        masks = super().blend_masks(originals_u8, edits_u8, need_earring)
        self.calls.append((originals_u8(), edits_u8(), list(need_earring),
                           masks))
        return masks


@pytest.fixture(scope="module")
def nets():
    """(generator params, the parser's params, styles of 3 seeds, a
    direction)."""
    gp = weights.make_model(weights.stylegan2_plan(G), "cpu", 5, "generator")
    parser = dl.init_deeplab_params(torch.Generator().manual_seed(0),
                                    layers=(1, 1, 1, 1), width=32)
    for name, b in BIAS.items():
        parser["aspp"]["conv3_bias"][dl.CLASSES.index(name)] = b
    z = torch.randn((3, 512), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        styles = w_to_s(gp, CFG, mapping(gp, CFG, z))
    d = torch.zeros((1, 26, 512))
    d[:, [2, 5, 8, 11], :64] = torch.randn(
        (1, 4, 64), generator=torch.Generator().manual_seed(2)) * 0.5
    return gp, parser, styles, d


def _ref_params(parser):
    return {k: _ref_params(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in parser.items()}


def test_deeplab_logits_agree(nets):
    _, parser, _, _ = nets
    x = torch.randn((2, 3, 97, 97), generator=torch.Generator().manual_seed(3))
    seg = dl.Segmenter(parser, device="cpu")
    with torch.no_grad():
        got = dl.deeplab_apply(seg.params, x)
        want = rdl.logits(_ref_params(parser), x)
    assert got.shape == want.shape == (2, 19, 97, 97)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_masks_agree_on_the_same_class_map():
    """Blobs of every class at several sizes: the port's morphology and
    the reference's, equal."""
    rng = np.random.RandomState(4)
    low = rng.randint(0, 19, (2, 24, 24)).astype(np.uint8)
    for cls in np.kron(low, np.ones((22, 22), np.uint8))[:, :512, :512]:
        assert np.array_equal(dl.bg_mask(cls), rdl.background(cls))
        want = rdl.earring_mouth_teeth(cls)
        got = (dl.earring_mask(cls), dl.mouth_mask(cls), dl.teeth_mask(cls))
        for a, b in zip(got, want):
            assert a.any() and np.array_equal(a, b)


@pytest.fixture(scope="module")
def blended(nets):
    """The editor's blended edits of the 3 styles for each prompt, with
    what its parser saw and gave."""
    gp, parser, styles, d = nets
    out = {}
    for prompt in (SMILE, MAN):
        editor = BatchEditor(CFG, gp, max_batch=2, device="cpu")
        editor.add_direction(prompt, d.numpy())
        seg = Kept(parser, device="cpu")
        editor.attach_segmenter(seg)
        out[prompt] = (editor.edit_styles(styles, 1.5, pairs=True,
                                          direction_name=prompt), seg)
    return out


def test_batch_editor_blends_like_the_reference(nets, blended):
    """3 rows in buckets of 2 and 1: one parser call for the originals and
    one for the edits of each bucket; each row's blend as the reference
    renders it from the port's masks, and the reference's own masks of
    the same renders as the port's."""
    gp, parser, styles, d = nets
    ref = _ref_params(parser)
    pairs, seg = blended[SMILE]
    assert seg.deeplab_calls == 4 and seg.deeplab_rows == 6
    assert [len(c[0]) for c in seg.calls] == [2, 1]
    assert all(c[2] == [True] * len(c[0]) for c in seg.calls)
    assert all(seg.masks_nonempty[k] > 0 for k in seg.masks_nonempty)
    rows = [(o, e, {k: m[i] for k, m in masks.items()})
            for o_, e_, _, masks in seg.calls
            for i, (o, e) in enumerate(zip(o_, e_))]
    differ = total = 0
    for i, (o, e, row) in enumerate(rows):
        for k, want in rdl.blend_masks(ref, o, e, True).items():
            differ += int((row[k] != want).sum())
            total += want.size
        with torch.no_grad():
            orig = rsg.to_levels(rsg.synthesis(gp, G, styles[i:i + 1]))[0]
            levels = rsg.to_levels(rblend.blended_edit(
                gp, G, styles[i:i + 1], styles[i:i + 1] + d * 1.5, row))[0]
        for want, got in ((orig, pairs[i, :, :64]),
                          (levels, pairs[i, :, 64:])):
            assert np.abs(want.numpy() - got.astype(np.float64)).max() <= 1.0
        # blending moved the edit toward the original
        plain = rsg.to_levels(rsg.synthesis(gp, G, styles[i:i + 1]
                                            + d * 1.5))[0]
        assert np.abs(plain.numpy() - levels.numpy()).max() > 1.0
    assert differ <= 1e-3 * total


@pytest.mark.parametrize("prompt", [SMILE, MAN])
def test_batched_rows_equal_the_one_item_case(nets, blended, prompt):
    """`apply_edit_item_with_blending`, row by row, renders what the
    batched path served; no earring mask for 'face of a man'."""
    gp, parser, styles, d = nets
    pairs, seg = blended[prompt]
    for _, _, need, masks in seg.calls:
        assert need == [needs_earring_mask(prompt)] * len(need)
        assert (masks["earring"] is None) == (prompt == MAN)
    one = dl.Segmenter(parser, device="cpu")
    for i in range(3):
        orig, edited = apply_edit_item_with_blending(
            gp, CFG, styles[i], d, 1.5, one, text_prompt=prompt)
        assert np.array_equal(np.concatenate([orig, edited], axis=1),
                              pairs[i])
    assert one.deeplab_calls == 6 and one.deeplab_rows == 6


def test_generate_fromS_blends_through_the_editor(nets, blended, tmp_path,
                                                   monkeypatch):
    """--use_blending 1 --batch 2: the CLI's JPEGs are those of the
    editor's blended pairs (the same rows in the same bucket)."""
    from stylemc_torch.cli.generate_fromS import main
    from stylemc_torch.io import save_native

    gp, parser, styles, d = nets
    save_native(str(tmp_path / "g.npz"), CFG, gp)
    np.savez(tmp_path / "s.npz", s=styles[:2].numpy())
    out = tmp_path / "out"
    out.mkdir()
    tag = SMILE.replace(" ", "_")
    np.savez(out / f"direction_{tag}.npz", s=d.numpy())
    dl.save_deeplab_checkpoint(str(tmp_path / "deeplab_model.pth"), parser)
    monkeypatch.setenv("STYLEMC_DEEPLAB", str(tmp_path / "deeplab_model.pth"))
    r = CliRunner().invoke(main, [
        "--network", str(tmp_path / "g.npz"), "--s_input",
        str(tmp_path / "s.npz"), "--outdir", str(out), "--text_prompt",
        SMILE, "--change_power", "1.5", "--use_blending", "1", "--batch",
        "2", "--device", "cpu"], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    pairs, _ = blended[SMILE]
    for i in range(2):
        want = io.BytesIO()
        Image.fromarray(pairs[i], "RGB").save(want, format="jpeg",
                                              quality=95)
        got = np.asarray(Image.open(out / f"{tag}_{i:03d}.jpeg"))
        assert np.array_equal(got, np.asarray(Image.open(want)))


def test_a_second_generator_renders_the_blended_edits(nets):
    """edit_generator (generate_fromS --network2): the edits, and their
    blend, come from the second generator, the originals and their
    features from the first, as in the one-item case's gen2."""
    gp, parser, styles, d = nets
    gp2 = weights.make_model(weights.stylegan2_plan(G), "cpu", 6,
                             "generator")
    editor = BatchEditor(CFG, gp, max_batch=1, device="cpu")
    editor.add_direction(SMILE, d.numpy())
    editor.attach_segmenter(dl.Segmenter(parser, device="cpu"),
                            edit_generator=(gp2, CFG))
    got = editor.edit_styles(styles[:1], 1.5, pairs=True,
                             direction_name=SMILE)[0]
    orig, edited = apply_edit_item_with_blending(
        gp, CFG, styles[0], d, 1.5, dl.Segmenter(parser, device="cpu"),
        text_prompt=SMILE, gen2=(gp2, CFG))
    assert np.array_equal(got, np.concatenate([orig, edited], axis=1))
    plain = BatchEditor(CFG, gp, max_batch=1, device="cpu")
    plain.add_direction(SMILE, d.numpy())
    assert not np.array_equal(got[:, 64:], plain.edit_styles(
        styles[:1], 1.5, direction_name=SMILE)[0])
