"""serve.queue_wait_p95_ms: the 95th percentile of the coalescing
dispatcher's queue wait (its `dispatch.wait` span: from `submit` to the
start of the call that carries the submission) over the submissions of the
window run again with the program's recorder on (benchmark.core.spans); a
submission no call carried reads as infinitely long. Submissions that
overlap the profiled stretch are left out."""

import math

import numpy as np

from benchmark.core import spans


def probe(ctx, state):
    return spans.replay(ctx, state)


def read(ctx, record):
    rep = record.get("probes", {}).get("serve.queue_wait_p95_ms")
    if not rep:
        return None
    carried = sum(1 for s in rep.spans if s.name == "dispatch.wait")
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in rep.kept("dispatch.wait")]
    ms += [math.inf] * max(0, rep.attempted - carried)
    if not ms:
        return None
    with np.errstate(invalid="ignore"):     # inf - inf past the last wait
        value = float(np.percentile(ms, 95))
    return math.inf if math.isnan(value) else value
