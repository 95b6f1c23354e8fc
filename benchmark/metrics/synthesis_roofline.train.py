"""synthesis_roofline.train: the generator's forward and backward to the
styles at the step's rows (batch x prompts), to until_k, through the
program's `synthesis`: twice its useful FLOPs over its device time (the
profiler's kernels over three calls), as a share of 165 TFLOP/s."""

import torch

from benchmark.core import flops, timing


def probe(ctx, state):
    from stylemc_torch.models.stylegan2.generator import synthesis

    rows = ctx.traffic["job"]["batch_size"] * ctx.traffic["prompts_per_job"]
    styles = state["styles"][:rows].clone()
    delta = torch.zeros_like(styles, requires_grad=True)
    until_k = ctx.config["until_k"]

    def call():
        img = synthesis(state["models"]["generator"], state["cfg"],
                        styles + delta, until_k=until_k, noise_mode="const")
        torch.autograd.grad(img, delta, torch.ones_like(img))

    return {"rows": rows, "ms": timing.busy_ms(call)}


def read(ctx, record):
    p = record.get("probes", {}).get("synthesis_roofline.train")
    if not p:
        return None
    useful = 2 * p["rows"] * flops.synthesis_flop(ctx.config["generator"],
                                                  ctx.config["until_k"])
    return 100.0 * useful / (p["ms"] / 1e3) / flops.PEAK_FLOP_PER_S
