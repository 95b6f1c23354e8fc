"""deeplab_roofline.blend: one bucket-16 network call of the editor's
face parser (`stylemc_torch.models.deeplab.deeplab_apply` on the
Segmenter's params, on 16 photos preprocessed to 513² ahead of the call):
DeepLab's FLOPs from the configuration's shapes (convolutions, ASPP and
the classifier; `benchmark.core.deeplab_flops`) over its device time (the
profiler's kernels over three calls), as a share of 165 TFLOP/s."""

import torch

from benchmark.core import deeplab_flops, flops, timing


def probe(ctx, state):
    from stylemc_torch.models.deeplab import deeplab_apply

    seg = state["segmenter"]
    rows = ctx.traffic["batch"]
    x = seg.network_input(state["pool"][:rows])

    def call():
        with torch.inference_mode():
            deeplab_apply(seg.params, x)

    return {"rows": rows, "ms": timing.busy_ms(call)}


def read(ctx, record):
    p = record.get("probes", {}).get("deeplab_roofline.blend")
    if not p:
        return None
    useful = p["rows"] * deeplab_flops.deeplab_flop(ctx.config)
    return 100.0 * useful / (p["ms"] / 1e3) / flops.PEAK_FLOP_PER_S
