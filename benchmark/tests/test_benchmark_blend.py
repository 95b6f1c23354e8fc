"""The blended photo cell at tiny widths on the CPU: its configuration's
weights and FLOPs, and whole runs with the timed path sound and broken.

This file imports both the program and the reference; the reference
imports neither the program nor JAX."""

import numpy as np
import pytest
import torch

from benchmark.core import deeplab_flops, deeplab_weights
from benchmark.core.cell import load_cell
from benchmark.core.runner import run_cell
from benchmark.reference import deeplab as rdl
from benchmark.tests.tiny_cells import cpu, tiny_cell

SEED = 2 ** 33 + 9
CELL = "ffhq1024_blend.photo_blend"


def tiny_blend_cell(**traffic):
    """The cell with a tiny generator and e4e (tiny_cells) and a parser of
    one block a stage at width 32, background and cloth favoured."""
    cell = tiny_cell(CELL, **traffic)
    cell.config["deeplab"].update(
        layers=[1, 1, 1, 1], widths=[32, 32, 32, 32], stem=32,
        aspp_depth=32, classifier_scale=1.0,
        classifier_bias={"background": 2.0, "cloth": 2.0})
    return cell


def test_the_configuration_is_resnet101_deeplabv3():
    config = load_cell(CELL).config
    d = config["deeplab"]
    assert d["layers"] == [3, 4, 23, 3] and d["groups"] == 32
    # ~142 GFLOP an image at 513²
    assert 1.35e11 < deeplab_flops.deeplab_flop(config) < 1.5e11
    plan = deeplab_weights.deeplab_plan(d)
    count = sum(int(np.prod(s)) for _, s, _ in plan.normal)
    assert 5.5e7 < count < 6.0e7


def test_the_weights_load_in_the_port_and_agree_with_the_reference():
    from stylemc_torch.models.deeplab import Segmenter, deeplab_apply

    cell = tiny_blend_cell()
    params = deeplab_weights.make_deeplab(cell.config, SEED, cpu())
    assert float(params["aspp"]["conv3_bias"][0]) == 2.0
    seg = Segmenter(params, device="cpu")
    x = torch.randn((1, 3, 65, 65))
    with torch.no_grad():
        got = deeplab_apply(seg.params, x)
        want = rdl.logits(params, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_a_sound_run_is_correct_and_blends():
    res = run_cell(tiny_blend_cell(), SEED, 0.5, False, cpu(), 0.0,
                   log=lambda *a: None)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["compared"]) == {"render_gap", "mask_mismatch",
                                    "logit_gap"}
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"edit_images_per_s", "setup_s"}


def _no_blend(monkeypatch):
    import stylemc_torch.serve as serve

    real = serve.blend_edits

    def unblended(gp, cfg, styles, edited, segmenter, need, **kw):
        orig, _ = real(gp, cfg, styles, edited, segmenter, need, **kw)
        from stylemc_torch.edit import to_u8_nhwc
        from stylemc_torch.models.stylegan2.generator import synthesis

        return orig, to_u8_nhwc(synthesis(gp, cfg, edited))

    monkeypatch.setattr(serve, "blend_edits", unblended)


def _wrong_image(monkeypatch):
    from stylemc_torch.models.deeplab import Segmenter

    real = Segmenter.blend_masks

    def rolled(self, originals, edits, need):
        return real(self, lambda: np.roll(originals(), 1, 0),
                    lambda: np.roll(edits(), 1, 0), need)

    monkeypatch.setattr(Segmenter, "blend_masks", rolled)


@pytest.mark.parametrize("fault", [_no_blend, _wrong_image],
                         ids=["no_blend", "wrong_image"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run_cell(tiny_blend_cell(), SEED, 0.5, False, cpu(), 0.0,
                   log=lambda *a: None)
    assert res["correct"] is False, res["compared"]
