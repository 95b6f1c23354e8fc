"""blend.host_share: the share of the window the face parser spent in its
host steps, its `segmenter.preprocess` spans (PIL's 513² resizes, the
normalisation and the copy of the batch to the device) and its
`segmenter.masks` spans (the nearest resizes to 512² and cv2's
morphology, per image), over the window run again with the program's
recorder on (benchmark.core.spans), the profiled stretch left out."""

from benchmark.core import spans


def probe(ctx, state):
    return spans.replay(ctx, state)


def read(ctx, record):
    rep = record.get("probes", {}).get("blend.host_share")
    if not rep:
        return None
    return rep.share("segmenter.preprocess", "segmenter.masks")
