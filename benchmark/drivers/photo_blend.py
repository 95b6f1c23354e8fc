"""A batch job that edits a folder of portraits with feature blending,
closed loop.

`stylemc_torch.serve.BatchEditor.edit_images` with an e4e inverter and a
DeepLab face parser attached (`attach_segmenter`, the reference's
`generate_fromS.py --use_blending`): batches of seeded 256² uint8 photos
(made on the card in set-up, held on the host as a user's decoded files
are) inverted by Encoder4Editing and turned into S-space styles; the
originals rendered keeping their 32² and 64² features, the edits
rendered, both parsed, and the edits rendered again with their features
blended toward the originals' under the earring (32²), background and
teeth (64²) masks. Each batch takes one of two named directions, drawn
from the run's seed at the traffic's shares; "face of a man" asks for no
earring mask. The window closes at the first batch that completes after
`--seconds`; the end-to-end metric is the photos edited over its wall
time.

What the check compares, for a seeded sample of the window's photos, is
what the timed path produced: its blended edits, the masks its parser
made (kept at 512² by a parser that keeps its last call's inputs and
masks), and the parser's logits of the same renders, from one call at
the timed bucket after the window. A program whose BatchEditor cannot
blend fails at once in set-up.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..core import compare, deeplab_weights, models as core_models, \
    precision, timing
from ..reference import blending, deeplab, perception, stylegan2
from . import program

# the planted faults `benchmark/calibrate.py --fault-seeds` runs: the
# unblended edit served, and each photo's masks taken from another photo
FAULTS = ("no_blend", "wrong_image")


def needs_earring(name: str) -> bool:
    return "face of a man" not in name


def _segmenter(params, resolution: int, device):
    """The program's Segmenter, keeping its last `blend_masks` call's
    renders (given as the functions that return them) and masks
    (references, no copies)."""
    from stylemc_torch.models.deeplab import Segmenter

    class Kept(Segmenter):
        last = None

        def blend_masks(self, originals_u8, edits_u8, need_earring):
            masks = super().blend_masks(originals_u8, edits_u8,
                                        need_earring)
            self.last = (originals_u8(), edits_u8(), masks)
            return masks

    return Kept(params, resolution=resolution, device=device)


def setup(ctx) -> Dict[str, Any]:
    from stylemc_torch.serve import BatchEditor

    if not hasattr(BatchEditor, "attach_segmenter"):
        raise RuntimeError("this program's BatchEditor cannot blend: it has "
                           "no attach_segmenter")
    from stylemc_torch.models.e4e.psp import PSP, PSPConfig

    t = ctx.traffic
    models = core_models.make_models(ctx.config, ctx.seed, ctx.device)
    models["deeplab"] = deeplab_weights.make_deeplab(ctx.config, ctx.seed,
                                                     ctx.device)
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
    seg = _segmenter(models["deeplab"], ctx.config["deeplab"]["class_map"],
                     ctx.device)
    editor.attach_segmenter(seg)
    names = [name for name, _ in t["directions"]]
    dirs = program.directions(ctx.seed, names, t["direction_scale"],
                              ctx.device)
    for name, d in dirs.items():
        editor.add_direction(name, d.cpu().numpy())
    pool = program.photos(ctx.seed, t["pool"], e["input_size"], ctx.device)
    for i in range(t["warmup_batches"]):
        editor.edit_images(pool[:t["batch"]], change_power=t["power"],
                           pairs=t["pairs"],
                           direction_name=names[i % len(names)])
    return {"models": models, "directions": dirs, "latent_avg": latent_avg,
            "editor": editor, "segmenter": seg, "pool": pool}


def window(ctx, state) -> Dict[str, Any]:
    t = ctx.traffic
    editor, seg, pool = state["editor"], state["segmenter"], state["pool"]
    names = [name for name, _ in t["directions"]]
    shares = np.array([s for _, s in t["directions"]], float)
    rng = program.seeded_rng(ctx.seed, "order")
    keep = t["check_images"]
    sample: Dict[int, Any] = {}
    seen = 0
    rec: Dict[str, Any] = {}
    tr = None
    traced_from = t["trace_batches"]
    counters = (seg.deeplab_calls, seg.deeplab_rows,
                dict(seg.masks_nonempty))
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    batches = 0
    while True:
        if ctx.trace and "trace" not in rec and batches == traced_from:
            tr = timing.Trace()
            tr.start()
        name = names[int(rng.choice(len(names), p=shares / shares.sum()))]
        idx = rng.choice(len(pool), size=t["batch"], replace=False)
        out = editor.edit_images(pool[idx], change_power=t["power"],
                                 pairs=t["pairs"], direction_name=name)
        batches += 1
        origs, edits, masks = seg.last
        # a seeded reservoir of the window's photos and what the timed
        # path made of each
        for row, photo in enumerate(idx):
            seen += 1
            slot = len(sample) if len(sample) < keep else \
                int(rng.integers(0, seen))
            if slot < keep:
                sample[slot] = {
                    "photo": int(photo), "direction": name,
                    "served": out[row].copy(), "orig": origs[row].copy(),
                    "edit": edits[row].copy(),
                    "masks": {k: None if m is None else m[row].copy()
                              for k, m in masks.items()}}
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
    calls, rows, nonempty = counters
    counts = {"deeplab_calls": seg.deeplab_calls - calls,
              "deeplab_rows": seg.deeplab_rows - rows,
              "blend.masks_nonempty": {
                  k: seg.masks_nonempty[k] - nonempty[k] for k in nonempty}}
    print(f"window counters {counts}", file=sys.stderr, flush=True)
    samples = list(sample.values())
    # the parser's logits of the sampled renders, one call at the timed
    # bucket, after the window
    imgs = np.stack([s[k] for s in samples for k in ("orig", "edit")])
    logits = seg.logits(imgs[:t["batch"]]).cpu()
    if len(imgs) > t["batch"]:
        logits = torch.cat([logits, seg.logits(imgs[t["batch"]:]).cpu()])
    rec.update(window_s=window_s, images=batches * t["batch"],
               attempted=batches * t["batch"], failed=0, counters=counts,
               outputs={"samples": samples, "logits": logits})
    return rec


def release(ctx, state) -> Dict[str, Any]:
    return {"models": state["models"], "directions": state["directions"],
            "latent_avg": state["latent_avg"], "pool": state["pool"]}


def _styles(ctx, inputs, sample, tf32: bool):
    """The reference's styles and edited styles of one sampled photo."""
    g = ctx.config["generator"]
    gp = inputs["models"]["generator"]
    enc, layout, taps = inputs["models"]["e4e"]
    dev = gp["mapping"]["w_avg"].device
    p = sample["photo"]
    x = torch.as_tensor(inputs["pool"][p:p + 1], device=dev)
    x = x.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with precision.tf32(tf32), torch.no_grad():
        codes = perception.e4e_codes(enc, layout, taps, x,
                                     ctx.config["e4e"]["n_styles"],
                                     inputs["latent_avg"])
        styles = stylegan2.w_to_s(gp, g, codes)
    return styles, styles + inputs["directions"][sample["direction"]] \
        * ctx.traffic["power"]


def reference_levels(ctx, inputs, sample, tf32: bool = False,
                     blend: bool = True) -> torch.Tensor:
    """The reference's unrounded uint8 levels of one sampled photo's
    blended edit, from the program's masks (or, without `blend`, of its
    unblended edit)."""
    g = ctx.config["generator"]
    gp = inputs["models"]["generator"]
    styles, edited = _styles(ctx, inputs, sample, tf32)
    with precision.tf32(tf32), torch.no_grad():
        img = blending.blended_edit(gp, g, styles, edited, sample["masks"]) \
            if blend else stylegan2.synthesis(gp, g, edited)
    return stylegan2.to_levels(img)[0]


def reference_logits(ctx, inputs, samples, tf32: bool = False
                     ) -> List[torch.Tensor]:
    """The reference's logits [19, 513, 513] of the sampled renders, the
    original and the edit of each in turn."""
    params = inputs["models"]["deeplab"]
    with precision.tf32(tf32):
        return [deeplab.image_logits(params, s[k]) for s in samples
                for k in ("orig", "edit")]


def reference_masks(ctx, samples, logits) -> List[Dict[str, Any]]:
    res = ctx.config["deeplab"]["class_map"]
    return [deeplab.masks_of(deeplab.classes(logits[2 * i], res),
                             deeplab.classes(logits[2 * i + 1], res),
                             needs_earring(s["direction"]))
            for i, s in enumerate(samples)]


def control(ctx, inputs, outputs, fault=None) -> Dict[str, Any]:
    """The reference in the program's place: at TF32 its blend from the
    program's masks, its masks and its logits of the program's renders;
    with a fault, the float32 reference's unblended edit served
    ('no_blend'), or each photo given the next sampled photo's masks
    ('wrong_image')."""
    samples = [dict(s) for s in outputs["samples"]]
    out = {"samples": samples, "logits": outputs["logits"]}
    if fault == "no_blend":
        for s in samples:
            s["served"] = compare.truncate_levels(reference_levels(
                ctx, inputs, s, blend=False)).cpu().numpy()
    elif fault == "wrong_image":
        for s, other in zip(samples, samples[1:] + samples[:1]):
            s["masks"] = other["masks"]
    else:
        for s in samples:
            s["served"] = compare.truncate_levels(reference_levels(
                ctx, inputs, s, tf32=True)).cpu().numpy()
        logits = reference_logits(ctx, inputs, samples, tf32=True)
        for s, masks in zip(samples, reference_masks(ctx, samples, logits)):
            s["masks"] = masks
        out["logits"] = torch.stack(logits).cpu()
    return out


def check(ctx, inputs, outputs) -> Dict[str, float]:
    """render_gap: the widest gap in uint8 levels over the sampled blended
    edits, the reference blending from the program's masks;
    mask_mismatch: the share of mask pixels, over every mask of the
    sampled photos, where the reference's masks of the program's renders
    differ from the program's; logit_gap: the widest gap between the
    reference's and the program's logits of those renders, over the
    largest |logit|."""
    samples = outputs["samples"]
    worst = 0.0
    for s in samples:
        worst = max(worst, compare.render_gap(
            reference_levels(ctx, inputs, s), torch.as_tensor(s["served"])))
    logits = reference_logits(ctx, inputs, samples)
    differ = total = 0
    for s, want in zip(samples, reference_masks(ctx, samples, logits)):
        for kind, m in want.items():
            got = s["masks"][kind]
            if m is None and got is None:
                continue
            shape = (m if m is not None else got).shape
            m = np.zeros(shape, bool) if m is None else m
            got = np.zeros(shape, bool) if got is None else got
            differ += int((m != got).sum())
            total += m.size
    gap = top = 0.0
    for want, got in zip(logits, outputs["logits"]):
        gap = max(gap, float((got.to(want.device) - want).abs().max()))
        top = max(top, float(want.abs().max()))
    return {"render_gap": worst, "mask_mismatch": differ / total,
            "logit_gap": gap / top}
