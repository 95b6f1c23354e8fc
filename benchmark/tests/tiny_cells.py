"""The benchmark's cells cut to sizes a CPU test holds: the same drivers,
readers and limits on small widths, so that a run on the CPU goes
through everything but the card."""

from __future__ import annotations

import copy

import torch

from benchmark.core.cell import load_cell

TINY_GENERATOR = {"img_resolution": 64, "channel_base": 512,
                  "channel_max": 32, "mapping_layers": 2}
TINY_CLIP = {"image_resolution": 32, "vision_layers": 1, "vision_width": 64,
             "vision_patch_size": 16, "transformer_width": 64,
             "transformer_heads": 1, "transformer_layers": 1,
             "embed_dim": 32}
TINY_IRSE = {"units": [1, 1, 1, 1], "widths": [8, 8, 16, 16], "stem": 8}
TINY_JOB = {"n_items": 20, "batch_size": 2, "n_epochs": 2, "resolution": 64}


def tiny_cell(name: str, **traffic):
    """The cell `name` at tiny widths; `traffic` overrides its traffic."""
    cell = copy.deepcopy(load_cell(name))
    c = cell.config
    c["generator"].update(TINY_GENERATOR)
    c["w_avg_samples"] = 64
    if "clip" in c:
        for clip in c["clip"].values():
            clip.update(TINY_CLIP)
        c["arcface"].update(TINY_IRSE, embed=32)
        c["until_k"] = 4
    if "job" in cell.traffic:
        cell.traffic["job"].update(TINY_JOB)
    if "e4e" in c:
        c["e4e"].update(TINY_IRSE, widths=[8, 16, 16, 32], n_styles=10)
        cell.traffic.update(batch=2, pool=4, max_batch=2, pipeline_chunk=2,
                            check_images=3, warmup_batches=1)
    if cell.traffic["kind"] == "open_edit":
        cell.traffic.update(rate_per_s=20.0, warmup_rows=[1, 2, 4, 8],
                            max_batch=8, pipeline_chunk=4, check_requests=4,
                            senders=16)
    cell.traffic.update(traffic)
    return cell


def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")
