"""The fused up-conv's two forms, polyphase against pad_dilate, forward only,
on one CUDA card: the A/B behind the form that forward-only synthesis runs.

    python -m stylemc_torch.bench.up_conv_ab

Every conv0 (the 3×3 up-conv of an upper block, FIR composed into a 6×6
kernel) that a served call runs, float32 with TF32 off, no grad:

  ffhq256   the full-width FFHQ-256 generator's six conv0s (8²–256² planes)
            at the serving buckets 1, 2, 4, 8 and 16 (larger requests
            render in chunks of 16)
  ffhq1024  the FFHQ-1024 decoder's eight conv0s (8²–1024²) at batch 16,
            the photo editor's batch

Each conv's two times are device times (CUDA events around calls queued
behind a sleep kernel), taken in turns polyphase, pad_dilate, pad_dilate,
polyphase; each side's time is the lower of its two. A whole synthesis call
in each form gives the call's device time (the profiler's kernels over
three calls, one stream) and so each conv's share of it. It prints one
JSON line per shape and one per synthesis call, with both forms' maximum
distance over max |y|. Without a CUDA device it raises.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import torch

from stylemc_torch.device import disable_tf32, resolve_device
from stylemc_torch.models.stylegan2.generator import (
    GeneratorConfig, init_generator_params, synthesis)
from stylemc_torch.ops import conv2d_resample, setup_filter

from .timing import device_ms_for, nvidia_smi_line

FORMS = ("polyphase", "pad_dilate")
GENERATORS = {
    "ffhq256": (GeneratorConfig(img_resolution=256), (1, 2, 4, 8, 16)),
    "ffhq1024": (GeneratorConfig(img_resolution=1024), (16,)),
}


def busy_ms(fn, calls: int = 3) -> float:
    """Device time per call of `fn`: the profiler's kernel and copy times
    over `calls` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / calls


def conv0_times(cfg: GeneratorConfig, batch: int, dev) -> Dict[int, dict]:
    """{block resolution: {form: ms, 'rel_gap': ...}} for each conv0."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    filt = setup_filter(cfg.resample_filter, device=dev)
    out = {}
    for res in cfg.block_resolutions[1:]:
        c_in, c_out = cfg.channels(res // 2), cfg.channels(res)
        x = torch.randn((batch, c_in, res // 2, res // 2), generator=gen,
                        device=dev)
        w = torch.randn((c_out, c_in, 3, 3), generator=gen, device=dev)

        def call(form, x=x, w=w):
            return conv2d_resample(x, w, f=filt, up=2, padding=1,
                                   flip_weight=False, up_impl=form)

        ys = {form: call(form) for form in FORMS}
        gap = float((ys["polyphase"] - ys["pad_dilate"]).abs().max()
                    / ys["pad_dilate"].abs().max())
        del ys
        ms = {form: [] for form in FORMS}
        for form in FORMS + FORMS[::-1]:
            ms[form].append(device_ms_for(lambda form=form: call(form)))
        out[res] = {"c_in": c_in, "c_out": c_out,
                    **{form: min(v) for form, v in ms.items()},
                    "rel_gap": gap}
    return out


def synthesis_ms(cfg: GeneratorConfig, params, batch: int, dev) -> dict:
    """{form: device ms of one synthesis call}."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    styles = torch.randn((batch, 26, 512), generator=gen, device=dev)
    out = {}
    for form in FORMS:
        fcfg = dataclasses.replace(cfg, up_conv_impl=form)
        out[form] = busy_ms(lambda: synthesis(params, fcfg, styles,
                                              noise_mode="const"))
    return out


def main() -> None:
    dev = resolve_device("cuda")
    disable_tf32(dev)
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)
    with torch.inference_mode():
        for name, (cfg, batches) in GENERATORS.items():
            params = init_generator_params(
                torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
            for batch in batches:
                call = synthesis_ms(cfg, params, batch, dev)
                convs = conv0_times(cfg, batch, dev)
                for res, row in convs.items():
                    print(json.dumps({
                        "generator": name, "batch": batch, "res": res, **row,
                        "poly_over_pad": row["polyphase"] / row["pad_dilate"],
                        "share_of_call": {f: row[f] / call[f] for f in FORMS},
                    }), flush=True)
                print(json.dumps({
                    "generator": name, "batch": batch, "synthesis_ms": call,
                    "conv0_ms": {f: sum(r[f] for r in convs.values())
                                 for f in FORMS},
                }), flush=True)
            del params
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
