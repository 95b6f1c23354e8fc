"""encoder_roofline.photo: one bucket-16 inversion through
`BatchEditor.invert_images` (uint8 to [-1, 1], Encoder4Editing at 256²,
latent_avg, the generator's affines): the encoder's and the affines'
FLOPs from their shapes over its device time (the profiler's kernels over three
calls), as a share of 165 TFLOP/s."""

import torch

from benchmark.core import flops, timing


def probe(ctx, state):
    editor = state["editor"]
    rows = ctx.traffic["batch"]
    x = torch.as_tensor(state["pool"][:rows], device=ctx.device)
    return {"rows": rows,
            "ms": timing.busy_ms(lambda: editor.invert_images(x))}


def read(ctx, record):
    p = record.get("probes", {}).get("encoder_roofline.photo")
    if not p:
        return None
    useful = p["rows"] * flops.inversion_flop(ctx.config)
    return 100.0 * useful / (p["ms"] / 1e3) / flops.PEAK_FLOP_PER_S
