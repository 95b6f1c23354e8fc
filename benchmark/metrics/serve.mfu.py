"""serve.mfu: the useful FLOPs of the images served in the window
(w_to_s and synthesis, up-convs at the polyphase count) over the
window's wall time, as a share of 165 TFLOP/s: the whole service's share
of the card's peak, which bounds what any of its kernels can add."""

from benchmark.core import flops


def read(ctx, record):
    if "latencies_ms" not in record or not record.get("images"):
        return None
    g = ctx.config["generator"]
    per_image = flops.synthesis_flop(g) + flops.w_to_s_flop(g)
    return 100.0 * record["images"] * per_image / record["window_s"] \
        / flops.PEAK_FLOP_PER_S
