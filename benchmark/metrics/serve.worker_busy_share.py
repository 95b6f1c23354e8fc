"""serve.worker_busy_share: the share of the window in which the
coalescing dispatcher's worker was in an editor call (its `dispatch.call`
spans, clipped to the window), over the window run again with the
program's recorder on (benchmark.core.spans), the profiled stretch left
out."""

from benchmark.core import spans


def probe(ctx, state):
    return spans.replay(ctx, state)


def read(ctx, record):
    rep = record.get("probes", {}).get("serve.worker_busy_share")
    if not rep:
        return None
    return rep.share("dispatch.call")
