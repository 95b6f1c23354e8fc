"""photo.mfu: the useful FLOPs of each photo edited (Encoder4Editing at
256², w_to_s, synthesis with up-convs at the polyphase count) times the
traced batches' photos per second (host clock), as a share of 165
TFLOP/s: the whole edit's share of the card's peak."""

from benchmark.core import flops


def read(ctx, record):
    if "trace" not in record:
        return None
    per_image = flops.inversion_flop(ctx.config) \
        + flops.synthesis_flop(ctx.config["generator"])
    rate = record["trace_images"] / record["trace"].window_s
    return 100.0 * per_image * rate / flops.PEAK_FLOP_PER_S
