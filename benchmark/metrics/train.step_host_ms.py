"""train.step_host_ms: the host's own time for one training step per
prompt: the median `train.step` span (the learning rate, the batch's index
draw and copy, the forward and backward and the update) less the host's
waits on the device inside it (its `copy.h2d` and `train.sync` spans),
over the steps of the window run again with the program's recorder on
(benchmark.core.spans), each job's first step and the steps that overlap
the profiled stretch left out, over the step's prompts; it compares with
direction_step_ms."""

import bisect
import statistics

from benchmark.core import spans


def probe(ctx, state):
    return spans.replay(ctx, state)


def read(ctx, record):
    rep = record.get("probes", {}).get("train.step_host_ms")
    if not rep:
        return None
    waits = {}
    for s in rep.spans:
        if s.name in spans.SYNC_SPANS:
            waits.setdefault(s.thread, []).append((s.start_ns, s.end_ns))
    waits = {t: spans.merge(iv) for t, iv in waits.items()}
    starts = {t: [a for a, _ in iv] for t, iv in waits.items()}
    ms = []
    for s in rep.kept("train.step"):
        if s.attrs["step"] > 1:
            iv = waits.get(s.thread, [])
            lo = max(0, bisect.bisect_right(starts.get(s.thread, []),
                                            s.start_ns) - 1)
            hi = bisect.bisect_left(starts.get(s.thread, []), s.end_ns)
            inside = spans.overlap(iv[lo:hi], [(s.start_ns, s.end_ns)])
            ms.append((s.end_ns - s.start_ns - inside) / 1e6
                      / s.attrs["prompts"])
    return statistics.median(ms) if ms else None
