"""train.mfu: find_direction's useful FLOPs per prompt-step (`train_flop`:
the generator's polyphase count, both CLIP image towers and IR-SE-50 at
112, forward and input gradient) over the traced steps' time per
prompt-step (host clock, ten steps between two callbacks' copies), as a
share of 165 TFLOP/s."""

from benchmark.core import flops, weights


def read(ctx, record):
    if "trace" not in record:
        return None
    c = ctx.config
    layout = weights.ir_se_layout(c["arcface"]["units"],
                                  c["arcface"]["widths"], c["arcface"]["stem"])
    per_step = flops.train_flop(c["generator"], c["clip"], c["arcface"],
                                layout, ctx.traffic["job"]["batch_size"],
                                c["until_k"])
    seconds = record["trace"].window_s / record["trace_prompt_steps"]
    return 100.0 * per_step / seconds / flops.PEAK_FLOP_PER_S
