"""synthesis_roofline.serve: one bucket-16 synthesis call on the editor's
own params and cfg (pad_dilate up-convs, as served): its useful FLOPs over
its device time (the profiler's kernels over three calls), as a share of 165
TFLOP/s."""

import torch

from benchmark.core import flops, timing

ROWS = 16


def probe(ctx, state):
    from stylemc_torch.models.stylegan2.generator import synthesis

    editor = state["editor"]
    styles = editor.styles_from_seeds(list(range(ROWS)))

    def call():
        with torch.inference_mode():
            synthesis(editor.params, editor.cfg, styles, noise_mode="const")

    return {"rows": ROWS, "ms": timing.busy_ms(call)}


def read(ctx, record):
    p = record.get("probes", {}).get("synthesis_roofline.serve")
    if not p:
        return None
    useful = p["rows"] * flops.synthesis_flop(ctx.config["generator"])
    return 100.0 * useful / (p["ms"] / 1e3) / flops.PEAK_FLOP_PER_S
