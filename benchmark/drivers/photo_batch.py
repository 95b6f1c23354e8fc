"""A batch job that edits a folder of photos, closed loop.

`stylemc_torch.serve.BatchEditor.edit_images` with an e4e inverter
attached: batches of seeded 256² uint8 photos (made on the card in set-up,
held on the host as a user's decoded files are) inverted by
Encoder4Editing, turned into S-space styles by the generator's affines,
edited by one named direction and rendered at the generator's resolution,
one call per batch, back to back. The window closes at the first batch
that completes after `--seconds`; the end-to-end metric is the photos
edited over its wall time. The reference checks a seeded sample of the
window's edited photos.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..core import compare, models as core_models, precision, timing
from ..reference import perception, stylegan2
from . import program

NAME = "photo"


def setup(ctx) -> Dict[str, Any]:
    from stylemc_torch.models.e4e.psp import PSP, PSPConfig
    from stylemc_torch.serve import BatchEditor

    t = ctx.traffic
    models = core_models.make_models(ctx.config, ctx.seed, ctx.device)
    cfg = program.generator_config(ctx.config["generator"])
    e = ctx.config["e4e"]
    latent_avg = models["generator"]["mapping"]["w_avg"][None].expand(
        e["n_styles"], -1).contiguous()
    editor = BatchEditor(cfg, models["generator"], max_batch=t["max_batch"],
                         precision=t["precision"],
                         pipeline_chunk=t["pipeline_chunk"],
                         device=ctx.device)
    editor.attach_inverter(PSP(
        cfg=PSPConfig(stylegan_size=cfg.img_resolution,
                      encoder_type="Encoder4Editing",
                      encoder_layout=models["e4e"][1]),
        encoder_params=models["e4e"][0], decoder_cfg=cfg, decoder_params={},
        latent_avg=latent_avg))
    d = program.directions(ctx.seed, [NAME], t["direction_scale"],
                           ctx.device)[NAME]
    editor.add_direction(NAME, d.cpu().numpy())
    pool = program.photos(ctx.seed, t["pool"], e["input_size"], ctx.device)
    for _ in range(t["warmup_batches"]):
        editor.edit_images(pool[:t["batch"]], change_power=t["power"],
                           pairs=t["pairs"], direction_name=NAME)
    return {"models": models, "direction": d, "latent_avg": latent_avg,
            "editor": editor, "pool": pool}


def window(ctx, state) -> Dict[str, Any]:
    t = ctx.traffic
    editor, pool = state["editor"], state["pool"]
    rng = program.seeded_rng(ctx.seed, "order")
    keep = t["check_images"]
    sample: Dict[int, Any] = {}
    seen = 0
    rec: Dict[str, Any] = {}
    tr = None
    traced_from = t["trace_batches"]
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    batches = 0
    while True:
        if ctx.trace and "trace" not in rec and batches == traced_from:
            tr = timing.Trace()
            tr.start()
        idx = rng.choice(len(pool), size=t["batch"], replace=False)
        out = editor.edit_images(pool[idx], change_power=t["power"],
                                 pairs=t["pairs"], direction_name=NAME)
        batches += 1
        # a seeded reservoir of (photo, edit) over the window's photos
        for row, photo in enumerate(idx):
            seen += 1
            slot = len(sample) if len(sample) < keep else \
                int(rng.integers(0, seen))
            if slot < keep:
                sample[slot] = (int(photo), out[row].copy())
        if tr is not None and batches == traced_from + t["trace_span"]:
            tr.stop()
            if tr.valid or batches >= t["trace_batches"] + 3 * t[
                    "trace_span"]:
                rec.update(trace=tr, trace_images=t["batch"] * t[
                    "trace_span"])
            else:
                traced_from = batches
            tr = None
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    rec.update(window_s=window_s, images=batches * t["batch"],
               attempted=batches * t["batch"], failed=0,
               outputs=list(sample.values()))
    return rec


def release(ctx, state) -> Dict[str, Any]:
    return {"models": state["models"], "direction": state["direction"],
            "latent_avg": state["latent_avg"], "pool": state["pool"]}


def reference_levels(ctx, inputs, photo: int, tf32: bool = False
                     ) -> torch.Tensor:
    """The reference's unrounded uint8 levels of one photo's edit."""
    g = ctx.config["generator"]
    gp = inputs["models"]["generator"]
    enc, layout, taps = inputs["models"]["e4e"]
    dev = gp["mapping"]["w_avg"].device
    x = torch.as_tensor(inputs["pool"][photo:photo + 1], device=dev)
    x = x.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with precision.tf32(tf32), torch.no_grad():
        codes = perception.e4e_codes(enc, layout, taps, x,
                                     ctx.config["e4e"]["n_styles"],
                                     inputs["latent_avg"])
        styles = stylegan2.w_to_s(gp, g, codes) + inputs["direction"] \
            * ctx.traffic["power"]
        return stylegan2.to_levels(stylegan2.synthesis(gp, g, styles))


def control(ctx, inputs, outputs):
    return [(photo, compare.truncate_levels(reference_levels(
        ctx, inputs, photo, tf32=True))[0].cpu().numpy())
        for photo, _ in outputs]


def check(ctx, inputs, outputs) -> Dict[str, float]:
    """render_gap: the widest gap over every value of the sampled edits."""
    worst = 0.0
    for photo, served in outputs:
        levels = reference_levels(ctx, inputs, photo)[0]
        worst = max(worst, compare.render_gap(levels, torch.as_tensor(
            np.asarray(served))))
    return {"render_gap": worst}
