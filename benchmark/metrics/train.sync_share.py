"""train.sync_share: the share of the window the trainer spent waiting on
the device: its `train.sync` spans (the first step's drain, the 10-step
callbacks' copies to the host, the loss history's copy) and the
`copy.h2d` spans (each step's batch indices and the filters, resampling
matrices and index rows its forward copies to the device from pageable
memory, each after the device's queue drains), over the window run again
with the program's recorder on (benchmark.core.spans), the profiled
stretch left out."""

from benchmark.core import spans


def probe(ctx, state):
    return spans.replay(ctx, state)


def read(ctx, record):
    rep = record.get("probes", {}).get("train.sync_share")
    if not rep:
        return None
    return rep.share(*spans.SYNC_SPANS)
