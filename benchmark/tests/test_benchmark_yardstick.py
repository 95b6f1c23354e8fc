"""The yardstick's parts on the CPU: traffic and inputs made from the
seed, the FLOP and byte arithmetic, and the comparison numbers."""

import numpy as np
import pytest
import torch

from benchmark.core import compare, flops, models, weights
from benchmark.core.cell import load_cell
from benchmark.core.tokenizer import token_ids
from benchmark.drivers import direction_jobs, open_edit, program
from benchmark.tests.tiny_cells import tiny_cell

BIG = 2 ** 31 + 12345


def test_flops_match_hand_counts():
    g256 = load_cell("ffhq256.edit_open").config["generator"]
    g1024 = load_cell("ffhq1024.photo_batch").config["generator"]
    assert flops.synthesis_flop(g256) == 167_470_153_728
    assert flops.synthesis_flop(g1024) == 283_736_260_608
    # the training cut to until_k 6 at 256 is the whole generator
    assert flops.synthesis_flop(g256, 6) == flops.synthesis_flop(g256)


def test_train_flop_counts_every_model():
    c = load_cell("ffhq256.find_direction").config
    layout = weights.ir_se_layout(c["arcface"]["units"],
                                  c["arcface"]["widths"], c["arcface"]["stem"])
    per_image = flops.train_flop(c["generator"], c["clip"], c["arcface"],
                                 layout, 1) // 2
    # 197 tokens of width 768 through 12 layers
    vit16 = flops.vit_flop(c["clip"]["ViT-B/16"])
    assert 34e9 < vit16 < 36e9
    assert per_image == flops.synthesis_flop(c["generator"]) + vit16 + \
        flops.vit_flop(c["clip"]["ViT-B/32"]) + flops.arcface_flop(
            c["arcface"], layout)


def test_resample_bytes_are_each_plane_read_and_written_once():
    g = load_cell("ffhq256.find_direction").config["generator"]
    up = sum(20 * 4 * 3 * (r // 2) ** 2 for r in (8, 16, 32, 64, 128, 256))
    down = sum(5 * 4 * 3 * r * r for r in (8, 16, 32, 64, 128, 256))
    assert flops.resample_step_bytes(g, 4) == up + down


@pytest.mark.parametrize("seed", [0, BIG, 2 ** 40 + 7])
def test_open_loop_schedule_is_fixed_and_the_latents_the_seeds(seed):
    traffic = load_cell("ffhq256.edit_open").traffic
    a = open_edit.schedule(traffic, 30, seed)
    assert a == open_edit.schedule(traffic, 30, seed)
    b = open_edit.schedule(traffic, 30, seed + 1)
    assert [(r["due"], r["direction"], len(r["seeds"])) for r in a] == \
        [(r["due"], r["direction"], len(r["seeds"])) for r in b]
    assert [r["seeds"] for r in a] != [r["seeds"] for r in b]
    n, rate = len(a), traffic["rate_per_s"]
    assert n == round(rate * 30)
    quantiles = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.diff([r["due"] for r in a])
    assert np.isclose(gaps[:, None], quantiles[None]).any(axis=1).all()
    assert abs(a[-1]["due"] - 30) < 3


def test_open_loop_mix_is_exact():
    traffic = load_cell("ffhq256.edit_open").traffic
    reqs = open_edit.schedule(traffic, 30, BIG)
    n = len(reqs)
    for size, share in traffic["seeds_per_request"]:
        count = sum(len(r["seeds"]) == size for r in reqs)
        assert abs(count - share * n) <= 1
    check = open_edit.check_set(reqs, traffic["check_requests"], BIG)
    assert max(len(r["seeds"]) for r in reqs) == max(
        len(reqs[i]["seeds"]) for i in check)


def test_prompt_order_and_inputs_follow_the_seed():
    cell = load_cell("ffhq256.find_direction")

    class Ctx:
        traffic = cell.traffic
        seed = BIG

    assert direction_jobs._pairs(Ctx, 20) == direction_jobs._pairs(Ctx, 20)
    dev = torch.device("cpu")
    assert np.array_equal(program.photos(BIG, 2, 32, dev),
                          program.photos(BIG, 2, 32, dev))
    assert not np.array_equal(program.photos(BIG, 2, 32, dev),
                              program.photos(BIG + 1, 2, 32, dev))
    assert torch.equal(program.zs(BIG, 3, 8, dev), program.zs(BIG, 3, 8, dev))


def test_weights_follow_the_seed():
    c = tiny_cell("ffhq256.find_direction").config
    dev = torch.device("cpu")
    a, b = models.make_models(c, BIG, dev), models.make_models(c, BIG, dev)
    other = models.make_models(c, BIG + 1, dev)
    def conv(m):
        return m["generator"]["synthesis"]["b8"]["conv0"]["weight"]

    assert torch.equal(conv(a), conv(b))
    assert not torch.equal(conv(a), conv(other))
    assert torch.equal(a["clip"]["ViT-B/16"][0]["token_embedding"],
                       b["clip"]["ViT-B/16"][0]["token_embedding"])


def test_tokens_are_framed_as_clip_frames_them():
    ids = token_ids(["A  face&amp;smile", "a face&smile"])
    assert ids.shape == (2, 77)
    assert (ids[0] == ids[1]).all()
    assert ids[0, 0] == 49406 and ids[0, ids[0].argmax()] == 49407


def test_render_gap_reads_the_distance_to_the_served_bin():
    levels = torch.tensor([[0.0, 10.2, 10.9, 254.99, 255.0]])
    assert compare.render_gap(levels, compare.truncate_levels(levels)) == 0.0
    served = torch.tensor([[0, 10, 11, 254, 255]], dtype=torch.uint8)
    assert compare.render_gap(levels, served) == pytest.approx(0.1, abs=1e-5)
