"""resample_roofline.train: B1 (upsample2x) and B2 (downsample2x), the
port's ToRGB-chain kernels, over the traced training steps: the least
time their bytes take at 3.35 TB/s (each input read once, each output
written once) over their device time in the profiler's trace."""

from benchmark.core import flops


def read(ctx, record):
    if "trace" not in record:
        return None
    tr = record["trace"]
    up_s, up_n = tr.kernel_seconds("upsample2x_kernel")
    down_s, down_n = tr.kernel_seconds("downsample2x_kernel")
    if not up_n or not down_n:
        return None
    rows = ctx.traffic["job"]["batch_size"] * ctx.traffic["prompts_per_job"]
    steps = record["trace_prompt_steps"] // ctx.traffic["prompts_per_job"]
    bound_s = steps * flops.resample_step_bytes(
        ctx.config["generator"], rows, ctx.config["until_k"]) \
        / flops.HBM_BYTES_PER_S
    return 100.0 * bound_s / (up_s + down_s)
