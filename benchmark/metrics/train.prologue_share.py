"""train.prologue_share: the share of the window the jobs spent before
their first step (their `train.prologue` spans: the original images'
features, the text anchors), over the window run again with the program's
recorder on (benchmark.core.spans), the profiled stretch left out."""

from benchmark.core import spans


def probe(ctx, state):
    return spans.replay(ctx, state)


def read(ctx, record):
    rep = record.get("probes", {}).get("train.prologue_share")
    if not rep:
        return None
    return rep.share("train.prologue")
