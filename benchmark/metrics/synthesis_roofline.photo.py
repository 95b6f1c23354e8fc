"""synthesis_roofline.photo: one bucket-16 synthesis call at the photo
generator's resolution on the editor's own params and cfg: its useful
FLOPs over its device time (the profiler's kernels over three calls), as a
share of 165 TFLOP/s."""

import torch

from benchmark.core import flops, timing


def probe(ctx, state):
    from stylemc_torch.models.stylegan2.generator import synthesis

    editor = state["editor"]
    rows = ctx.traffic["batch"]
    styles = editor.invert_images(state["pool"][:rows])

    def call():
        with torch.inference_mode():
            synthesis(editor.params, editor.cfg, styles, noise_mode="const")

    return {"rows": rows, "ms": timing.busy_ms(call)}


def read(ctx, record):
    p = record.get("probes", {}).get("synthesis_roofline.photo")
    if not p:
        return None
    useful = p["rows"] * flops.synthesis_flop(ctx.config["generator"])
    return 100.0 * useful / (p["ms"] / 1e3) / flops.PEAK_FLOP_PER_S
