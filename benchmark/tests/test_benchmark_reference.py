"""The plain reference against the program at tiny widths on the CPU, and
whole runs of each cell there with the timed path sound and broken.

This file imports both the program and the reference; the reference
imports neither the program nor JAX."""

import numpy as np
import pytest
import torch

from benchmark.core import compare, models
from benchmark.core.cell import load_cell
from benchmark.core.runner import run_cell
from benchmark.core.tokenizer import FrozenTokenizer, token_ids
from benchmark.drivers import program
from benchmark.reference import perception, stylegan2, stylemc
from benchmark.tests.tiny_cells import cpu, tiny_cell

SEED = 2 ** 33 + 5


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def train_models():
    cell = tiny_cell("ffhq256.find_direction")
    return cell.config, models.make_models(cell.config, SEED, cpu())


@pytest.mark.parametrize("up_conv_impl", ["polyphase", "pad_dilate"])
def test_generator_agrees(train_models, up_conv_impl):
    import dataclasses

    from stylemc_torch.models.stylegan2.generator import (mapping, synthesis,
                                                          w_to_s)

    config, m = train_models
    g, gp = config["generator"], m["generator"]
    cfg = dataclasses.replace(program.generator_config(g),
                              up_conv_impl=up_conv_impl)
    z = program.zs(SEED, 3, 512, cpu())
    with torch.no_grad():
        s_prog = w_to_s(gp, cfg, mapping(gp, cfg, z, truncation_psi=0.7))
        s_ref = stylemc.styles_of(m, g, z, 0.7)
        assert _rel(s_prog, s_ref) < 1e-6
        img = synthesis(gp, cfg, s_ref, noise_mode="const")
        ref = stylegan2.synthesis(gp, g, s_ref)
    assert ref.std() > 0.05 and ref.abs().max() < 1.5
    assert _rel(img, ref) < 1e-5


def test_perception_models_agree(train_models):
    from stylemc_torch.losses.id_loss import extract_feats
    from stylemc_torch.models.clip import (encode_image, encode_text,
                                           tokenize, unprocess)

    config, m = train_models
    img = torch.rand((2, 3, 64, 64)) * 2 - 1
    for name, (cfg, params) in program.clip_models(m).items():
        c = config["clip"][name]
        ref = perception.clip_image(params, c, perception.clip_preprocess(
            img, c["image_resolution"]))
        assert _rel(encode_image(params, cfg, unprocess(
            img, cfg.image_resolution)), ref) < 1e-5
        text = ["a face with a big smile", "a  face"]
        assert (tokenize(text, tokenizer=FrozenTokenizer())
                == token_ids(text)).all()
        ref = perception.clip_text(params, c, torch.as_tensor(
            token_ids(text)))
        assert _rel(encode_text(params, cfg, tokenize(
            text, tokenizer=FrozenTokenizer())), ref) < 1e-5
    arc, layout = m["arcface"]
    assert _rel(extract_feats(arc, img, layout),
                perception.arcface(arc, layout, img)) < 1e-5


def test_e4e_agrees():
    from stylemc_torch.models.e4e.psp import PSP, PSPConfig

    cell = tiny_cell("ffhq1024.photo_batch")
    m = models.make_models(cell.config, SEED, cpu())
    enc, layout, taps = m["e4e"]
    n = cell.config["e4e"]["n_styles"]
    avg = torch.randn(n, 512)
    psp = PSP(cfg=PSPConfig(stylegan_size=64, encoder_layout=layout),
              encoder_params=enc, decoder_cfg=None, decoder_params={},
              latent_avg=avg)
    x = torch.as_tensor(program.photos(SEED, 2, 256, cpu())).permute(
        0, 3, 1, 2).float() / 127.5 - 1
    with torch.no_grad():
        ref = perception.e4e_codes(enc, layout, taps, x, n, avg)
        assert _rel(psp.encode(x), ref) < 1e-5


def test_one_training_step_agrees(train_models):
    """Loss and gradient of the first step, the CLI's start and batch."""
    from stylemc_torch.train import find_direction as fd

    config, m = train_models
    g = config["generator"]
    job = tiny_cell("ffhq256.find_direction").traffic["job"]
    cfg = program.generator_config(g)
    z = program.zs(SEED, job["n_items"], 512, cpu())
    styles = stylemc.styles_of(m, g, z, 0.7)
    pair = ["a face with a big smile", "a face"]
    from benchmark.drivers.direction_jobs import _fdc

    fdc = _fdc(job, pair, m["arcface"][1])
    bundles = fd.make_clip_bundles(fdc, program.clip_models(m),
                                   FrozenTokenizer())
    ids, clip_f = fd.precompute_original_features(
        m["generator"], cfg, styles, bundles, m["arcface"][0], fdc)
    loss_fn = fd.make_loss_fn(m["generator"], cfg, bundles, m["arcface"][0],
                              fdc)
    idx = torch.as_tensor(stylemc.batch_order(0, job["n_items"],
                                              job["batch_size"], 1)[0])
    d = stylemc.initial_delta(0).requires_grad_(True)
    loss, _ = loss_fn(d, styles[idx], ids[idx], tuple(c[idx] for c in clip_f))
    grad, = torch.autograd.grad(loss.sum(), d)
    tokens = {"pos": torch.as_tensor(token_ids([pair[0]])),
              "neg": torch.as_tensor(token_ids([pair[1]]))}
    ref = stylemc.follow(m, g, styles, tokens, job, 1, config["until_k"])
    assert float((loss.detach() - ref["losses"][0]).abs()
                 / ref["losses"][0]) < 1e-4
    # the first step's CLIP edit is a difference of features 1e-3 apart:
    # its direction carries the rounding of both sides at ~1e-4
    step = stylemc.cosine_lr(job["learning_rate"], 1, 2 * 10)
    ref_grad = (stylemc.initial_delta(0) - ref["delta"]) / np.float32(step)
    assert float((grad - ref_grad).norm() / ref_grad.norm()) < 3e-3


CELLS = ["ffhq256.find_direction", "ffhq256.sweep4", "ffhq256.edit_open",
         "ffhq1024.photo_batch"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_completes_and_reads_small_gaps(name):
    cell = tiny_cell(name)
    res = run_cell(cell, SEED, 0.5, False, cpu(), 0.0, log=lambda *a: None)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == set(cell.limits)
    for value in (c["value"] for c in res["compared"].values()):
        assert np.isfinite(value) and value < 0.05, res["compared"]
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])


def _unchanged_state(monkeypatch):
    from stylemc_torch.train import find_direction as fd

    real = fd._sgd_step

    def step(loss_fn, bank, delta_s, idx, lr, text_dirs=None):
        out = real(loss_fn, bank, delta_s, idx, lr, text_dirs)
        return (delta_s.detach(),) + out[1:]

    monkeypatch.setattr(fd, "_sgd_step", step)


def _half_batch(monkeypatch):
    from stylemc_torch.train import find_direction as fd

    real = fd._sgd_step

    def step(loss_fn, bank, delta_s, idx, lr, text_dirs=None):
        return real(loss_fn, bank, delta_s, idx[:idx.shape[0] // 2], lr,
                    text_dirs)

    monkeypatch.setattr(fd, "_sgd_step", step)


def _altered_answer(monkeypatch):
    import stylemc_torch.serve as serve

    real = serve.to_u8_nhwc

    def to_u8(img):
        out = real(img).clone()
        out[:, 5, 7, 1] = out[:, 5, 7, 1] ^ 8
        return out

    monkeypatch.setattr(serve, "to_u8_nhwc", to_u8)


FAULTS = [("ffhq256.find_direction", _unchanged_state),
          ("ffhq256.find_direction", _half_batch),
          ("ffhq256.sweep4", _unchanged_state),
          ("ffhq256.sweep4", _half_batch),
          ("ffhq256.edit_open", _altered_answer),
          ("ffhq1024.photo_batch", _altered_answer)]


@pytest.mark.parametrize("name, fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in
                              FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """The whole run but the look for a card, the timed path broken
    underneath: `correct` comes out false against the cell's limits."""
    fault(monkeypatch)
    res = run_cell(tiny_cell(name), SEED, 0.5, False, cpu(), 0.0,
                   log=lambda *a: None)
    assert res["correct"] is False, res["compared"]


def test_the_limits_lie_between_their_readings():
    for name in CELLS:
        for number, lim in load_cell(name).limits.items():
            if "lower" in lim:
                assert lim["lower"] < lim["limit"] < lim["upper"], (name,
                                                                    number)


def test_control_gaps_of_a_truncated_render_are_zero():
    levels = torch.rand(2, 8, 8, 3) * 255
    assert compare.render_gap(levels, compare.truncate_levels(levels)) == 0
