"""The program's own spans over a second run of a cell's window, put on
the device trace's clock.

The metrics with "source": "program_span" read what the program's recorder
(`stylemc_torch.utils.profiling`) keeps while the cell's window runs once
more after the measured one: `replay` turns the recorder on, runs the
cell's `window` with tracing off, and profiles its last `PROFILE_S`
seconds, to the window's return, from a thread of its own
(`AnchoredTrace`). Starting and stopping the profiler stalls the process
for up to seconds, and work queued behind a stall waits longer, so the
stretch comes last, where nothing queues behind it; the readers leave out
the spans that overlap it (`kept`) and its time (`share`), so they read
the program as the untraced window runs it.

`AnchoredTrace` learns the offset between `time.perf_counter_ns()` and the
profiler's event times from anchors: at the stretch's start and stop it
brackets non-blocking CUDA runtime calls (`cudaStreamQuery`) between host
clock reads and finds those calls among the trace's runtime events. It
names each of the longest idle gaps by the CUDA call the host was in at
the gap's start and, after " @ ", the innermost program span that covers
the largest part of the gap on a thread that launches device work.

With a program that has no recorder, `replay` returns None and the readers
nothing.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import timing

# the host's waits on the device: the trainer's drains and copies to the
# host, and host data copied to the device from pageable memory
SYNC_SPANS = ("train.sync", "copy.h2d")
# spans of the threads that launch device work (the dispatcher's worker,
# the trainer): the candidates for an idle gap's label
DEVICE_SPANS = ("dispatch.drain", "dispatch.call", "editor.", "generator.",
                "train.")
ANCHOR_CALLS = 3
PROFILE_S = 2.0

Interval = Tuple[float, float]


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from stylemc_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "start_recording") else None


def merge(intervals) -> List[List[float]]:
    """Sorted, overlaps merged."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sets of intervals."""
    a, b = merge(a), merge(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def offset_from(brackets: Sequence[Tuple[int, int]],
                events: Sequence[Interval]) -> Tuple[float, float]:
    """The offset (ns) from the profiler's clock (us) to the host's, each
    bracket [a, b] (host ns) holding the runtime event [s, e] (us) matched
    to it in order: a <= s·1000 + offset and e·1000 + offset <= b. → (the
    middle of the offsets every pair allows, half their range: the error;
    negative where the pairs disagree)."""
    lo = max(a - s * 1e3 for (a, _), (s, _) in zip(brackets, events))
    hi = min(b - e * 1e3 for (_, b), (_, e) in zip(brackets, events))
    return (lo + hi) / 2, (hi - lo) / 2


def _bracket() -> List[Tuple[int, int]]:
    stream = torch.cuda.current_stream()
    out = []
    for _ in range(ANCHOR_CALLS):
        a = time.perf_counter_ns()
        stream.query()
        out.append((a, time.perf_counter_ns()))
    return out


class AnchoredTrace(timing.Trace):
    """`timing.Trace` with anchors at its start and stop. After `read()`:
    `stretch` [host ns from before the profiler's start to after its
    stop], `anchors` [(offset ns, error ns)] at start and stop, `offset_ns`,
    `idle_us` every idle gap [start, end] on the profiler's clock."""

    def start(self, sync: bool = True) -> None:
        t = time.perf_counter_ns()
        super().start(sync)
        self._brackets = [_bracket()]
        self.stretch = [t, t]

    def stop(self, sync: bool = True, read: bool = True) -> None:
        if sync:
            torch.cuda.synchronize()
        self._brackets.append(_bracket())
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.stretch[1] = time.perf_counter_ns()
        if read:
            self.read()

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType

        super()._read(prof)
        device, self._host, queries = [], [], []
        for evt in prof.events():
            tr = evt.time_range
            if evt.device_type == DeviceType.CUDA:
                device.append((tr.start, tr.end))
            else:
                self._host.append((tr.start, tr.end, evt.name))
                if evt.name == "cudaStreamQuery":
                    queries.append((tr.start, tr.end))
        busy = merge(device)
        self.idle_us = [(busy[i][1], busy[i + 1][0])
                        for i in range(len(busy) - 1)]
        queries.sort()
        self.anchors = [offset_from(self._brackets[0], queries[:ANCHOR_CALLS]),
                        offset_from(self._brackets[1],
                                    queries[-ANCHOR_CALLS:])]
        self.offset_ns = (self.anchors[0][0] + self.anchors[1][0]) / 2

    def on_clock(self, span) -> Interval:
        """A span's [start, end] on the profiler's clock (us)."""
        return ((span.start_ns - self.offset_ns) / 1e3,
                (span.end_ns - self.offset_ns) / 1e3)

    def labelled_gaps(self, spans, top: int = 10) -> List[List[Any]]:
        """The `top` longest idle gaps as [label, seconds]: each instant of
        a gap goes to the innermost span open on each device thread then,
        or to 'no span' where none is, and the name with the most time
        labels the gap."""
        threads = {s.thread for s in spans if s.name.startswith(DEVICE_SPANS)}
        cands = [(*self.on_clock(s), s.thread, s.name) for s in spans
                 if s.thread in threads]
        out = []
        for s, e in sorted(self.idle_us, key=lambda g: g[0] - g[1])[:top]:
            near = [c for c in cands if c[0] < e and c[1] > s]
            cuts = sorted({s, e} | {t for c in near for t in c[:2]
                                    if s < t < e})
            time_of: Dict[str, float] = {}
            for p, q in zip(cuts, cuts[1:]):
                inner: Dict[int, Tuple[float, float, str]] = {}
                for a, b, thread, name in near:
                    if a <= p and b >= q and (thread not in inner
                                              or a > inner[thread][0]):
                        inner[thread] = (a, b, name)
                for name in [v[2] for v in inner.values()] or ["no span"]:
                    time_of[name] = time_of.get(name, 0.0) + q - p
            name = max(time_of, key=time_of.get)
            out.append([f"{self._host_at(self._host, s)} @ {name}",
                        (e - s) / 1e6])
        return out

    def idle_by_span(self, spans) -> Dict[str, float]:
        """{span name: idle seconds its spans cover}."""
        by: Dict[str, List[Interval]] = {}
        for s in spans:
            by.setdefault(s.name, []).append(self.on_clock(s))
        return {name: overlap(iv, self.idle_us) / 1e6
                for name, iv in by.items()}


@dataclasses.dataclass
class Replay:
    """The spans of one replayed window (host ns), recorded from just
    before the cell's window starts to its return. `window` [start,
    start + the window's length]; `excluded` the profiled stretch;
    `attempted` the window's operations; `dropped` the spans the recorder's
    bound turned away."""
    spans: list
    window: Tuple[int, int]
    excluded: List[Tuple[int, int]]
    attempted: int
    dropped: int

    def kept(self, name: str) -> list:
        """The spans named `name` that overlap no excluded stretch."""
        return [s for s in self.spans if s.name == name and not any(
            s.start_ns < x1 and s.end_ns > x0 for x0, x1 in self.excluded)]

    def measured(self) -> Tuple[List[Tuple[int, int]], float]:
        """The window's excluded part, and the length of the rest (ns)."""
        w0, w1 = self.window
        out = [(max(x0, w0), min(x1, w1)) for x0, x1 in self.excluded
               if x0 < w1 and x1 > w0]
        return out, w1 - w0 - sum(x1 - x0 for x0, x1 in out)

    def share(self, *names: str) -> float:
        """The time the spans named one of `names` cover in the window less
        its excluded part, over that time (%)."""
        out, length = self.measured()
        iv = [(s.start_ns, s.end_ns) for s in self.spans if s.name in names]
        return 100.0 * (overlap(iv, [self.window]) - overlap(iv, out)) / \
            length


def replay(ctx, state) -> Optional[Replay]:
    """The cell's window run again with the recorder on, once a run (kept in
    the cell's `state`): every program_span metric's probe shares it."""
    if "spans.replay" not in state:
        state["spans.replay"] = _replay(ctx, state)
    return state["spans.replay"]


def _profile(trace: AnchoredTrace, at_ns: int,
             done: threading.Event) -> None:
    if done.wait(max(0.0, (at_ns - time.perf_counter_ns()) / 1e9)):
        return
    trace.start(sync=False)
    done.wait()
    trace.stop(sync=False, read=False)


def _replay(ctx, state) -> Optional[Replay]:
    prof = recorder()
    if prof is None:
        return None
    trace = AnchoredTrace() if ctx.device.type == "cuda" else None
    done = threading.Event()
    prof.start_recording()
    t0 = time.perf_counter_ns()
    timer = None
    if trace is not None:
        at = t0 + int(max(0.0, ctx.seconds - PROFILE_S) * 1e9)
        timer = threading.Thread(target=_profile, args=(trace, at, done))
        timer.start()
    try:
        record = ctx.cell.driver.window(dataclasses.replace(ctx, trace=False),
                                        state)
    finally:
        done.set()
        if timer is not None:
            timer.join()
        spans = prof.drain_spans()
        dropped = prof.stop_recording()
    window = (t0, t0 + int(record["window_s"] * 1e9))
    excluded = []
    if trace is not None and trace.window_s:
        trace.read()
        excluded.append(tuple(trace.stretch))
    out = Replay(spans, window, excluded, record["attempted"], dropped)
    report(out, trace, prof)
    return out


def report(rep: Replay, trace: Optional[AnchoredTrace], prof) -> None:
    """To stderr: the anchors' offset and error, the labelled idle gaps,
    and each span name's count, total, self and idle time over the
    window."""
    log = lambda *a: print(*a, file=sys.stderr)  # noqa: E731
    w0, w1 = rep.window
    idle: Dict[str, float] = {}
    if trace is not None and trace.window_s:
        (o0, e0), (o1, e1) = trace.anchors
        log(f"span clock: offset {o0:.0f} ns (error {e0 / 1e3:.3f} us) at "
            f"the stretch's start, {o1:.0f} ns ({e1 / 1e3:.3f} us) at its "
            f"stop; drift {abs(o1 - o0) / 1e3:.3f} us over "
            f"{trace.window_s:.3f} s; device busy {trace.busy_s:.4f} s")
        log("span idle_gaps " + repr(trace.labelled_gaps(rep.spans)))
        idle = trace.idle_by_span(rep.spans)
    own = prof.self_ns(rep.spans)
    names = sorted({s.name for s in rep.spans})
    left = (w1 - w0 - rep.measured()[1]) / 1e9
    log(f"spans over the window ({(w1 - w0) / 1e9:.3f} s, {left:.3f} s of "
        f"it profiled and left out; {len(rep.spans)} spans, {rep.dropped} "
        f"dropped; idle over the profiled stretch):")
    for name in names:
        group = rep.kept(name)
        if not group:
            continue
        ms = [(s.end_ns - s.start_ns) / 1e6 for s in group]
        q = statistics.quantiles(ms, n=20)[-1] if len(ms) > 1 else ms[0]
        log(f"  {name:<16} count {len(group):6d} total {sum(ms):10.3f} ms "
            f"self {sum(own[s.id] for s in group) / 1e6:10.3f} ms "
            f"p50 {statistics.median(ms):9.3f} p95 {q:9.3f} ms "
            f"idle {1e3 * idle.get(name, 0.0):8.3f} ms")
