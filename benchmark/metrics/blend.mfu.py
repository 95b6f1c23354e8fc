"""blend.mfu: the useful FLOPs of each photo edited with blending
(Encoder4Editing at 256² and w_to_s; three syntheses, with up-convs at the
polyphase count: the original, the edit and the blended edit; two DeepLab
passes at 513², the original's and the edit's) times the traced batches'
photos per second (host clock), as a share of 165 TFLOP/s: the whole
blended edit's share of the card's peak."""

from benchmark.core import deeplab_flops, flops


def read(ctx, record):
    if "trace" not in record:
        return None
    per_image = flops.inversion_flop(ctx.config) \
        + 3 * flops.synthesis_flop(ctx.config["generator"]) \
        + 2 * deeplab_flops.deeplab_flop(ctx.config)
    rate = record["trace_images"] / record["trace"].window_s
    return 100.0 * per_image * rate / flops.PEAK_FLOP_PER_S
