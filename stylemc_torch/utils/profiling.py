"""Tracing and profiling helpers (counterpart of
`stylemc_tpu/utils/profiling.py`).

`profiled_function` and `record_function` name a span in a
`torch.profiler` trace; `trace` captures one and writes it as a Chrome
trace (chrome://tracing, Perfetto); `count_params` and
`print_params_summary` count the parameters of a params tree (nested dicts
of tensors or arrays) or of an `nn.Module`.

The same spans also go to an in-memory recorder while one is on:

    start_recording()
    ...                      # every record_function / profiled_function
    spans = drain_spans()    # the spans closed since, in closing order
    dropped = stop_recording()

Each `Span` holds its name, start and end (`time.perf_counter_ns()`), the
OS thread id, its own id and its parent's (the enclosing span on the same
thread), a request id where the caller gives one, and a few attributes.
The buffer holds at most `MAX_SPANS`; later spans are counted as dropped.
With the recorder off a span costs one flag check beside the profiler
range: no clock read, nothing kept.

`to_device` copies host data (filters, resampling matrices, indices) to a
device inside a `copy.h2d` span: from pageable memory the copy starts only
once the device's queue has drained, so on a CUDA device the span times a
host wait on the device.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    NamedTuple, Optional)

import numpy as np
import torch

from ..device import DeviceLike


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    attrs: Dict[str, Any]


MAX_SPANS = 1_000_000


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(span)
            else:
                self.dropped += 1


_recorder: Optional[_Recorder] = None
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def start_recording() -> None:
    """Record every span from now on, in a new buffer."""
    global _recorder
    _recorder = _Recorder()


def drain_spans() -> List[Span]:
    """The spans recorded since the last drain (empty while off)."""
    rec = _recorder
    if rec is None:
        return []
    with rec.lock:
        spans, rec.spans = rec.spans, []
    return spans


def stop_recording() -> int:
    """Stop recording (undrained spans are dropped); → the spans the
    bound turned away."""
    global _recorder
    rec, _recorder = _recorder, None
    return 0 if rec is None else rec.dropped


def current_span() -> Optional[int]:
    """The innermost open span on this thread while recording, else None."""
    if _recorder is None:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def add_span(name: str, start_ns: int, end_ns: int, thread: int,
             parent: Optional[int] = None, request: Optional[int] = None,
             **attrs) -> None:
    """Record a span timed elsewhere (one thread opens it, another closes
    it), while recording."""
    rec = _recorder
    if rec is not None:
        rec.add(Span(name, start_ns, end_ns, thread, next(_ids), parent,
                     request, attrs))


@contextlib.contextmanager
def record_function(name: str, request: Optional[int] = None,
                    **attrs) -> Iterator[Optional[int]]:
    """A named profiler span; while recording, also a `Span` with
    `request` and `attrs`. Yields the span's id (None while off)."""
    rec = _recorder
    if rec is None:
        with torch.profiler.record_function(name):
            yield None
        return
    stack = _stack()
    sid = next(_ids)
    parent = stack[-1] if stack else None
    stack.append(sid)
    start = time.perf_counter_ns()
    try:
        with torch.profiler.record_function(name):
            yield sid
    finally:
        end = time.perf_counter_ns()
        stack.pop()
        rec.add(Span(name, start, end, threading.get_native_id(), sid,
                     parent, request, attrs))


def to_device(data, device: DeviceLike, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """`torch.as_tensor(data, dtype=dtype, device=device)` as a `copy.h2d`
    span."""
    with record_function("copy.h2d"):
        return torch.as_tensor(data, dtype=dtype, device=device)


def profiled_function(fn: Optional[Callable] = None, *,
                      name: Optional[str] = None) -> Callable:
    """Run `fn` inside a span named `name` (by default after `fn`); use as
    `@profiled_function` or `@profiled_function(name=...)`."""
    if fn is None:
        return functools.partial(profiled_function, name=name)
    label = name or fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def self_ns(spans: Iterable[Span]) -> Dict[int, int]:
    """{span id: its duration less the part its children cover}."""
    spans = list(spans)
    children: Dict[int, List[Span]] = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                reach = hi
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


@contextlib.contextmanager
def trace(log_dir: str, file_name: str = "trace.json",
          device: DeviceLike = None) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU, and CUDA when `device` is a CUDA device)
    and write it to `log_dir/file_name` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, file_name))


def _leaves(tree) -> List:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):  # in sorted key order, as JAX flattens
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def count_params(params) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in _leaves(params))


def print_params_summary(params, name: str = "params", max_depth: int = 2,
                         file=None) -> int:
    """Per-subtree parameter counts, one row each down to `max_depth`, then
    the total. An `nn.Module` is read as its named children."""
    rows = [("name", "params", "shape-sample")]

    def children(tree):
        if isinstance(tree, torch.nn.Module):
            return dict(tree.named_children()) or None
        return tree if isinstance(tree, dict) else None

    def walk(tree, prefix, depth):
        kids = children(tree)
        if depth >= max_depth or kids is None:
            leaves = _leaves(tree)
            n = sum(int(np.prod(tuple(x.shape))) for x in leaves)
            sample = str(tuple(leaves[0].shape)) if leaves else "-"
            rows.append((prefix, str(n), sample))
            return
        for k in kids:
            walk(kids[k], f"{prefix}.{k}", depth + 1)

    walk(params, name, 0)
    total = count_params(params)
    rows.append(("TOTAL", str(total), ""))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)), file=file)
    return total
