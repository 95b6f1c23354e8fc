"""Tracing and profiling helpers (counterpart of
`stylemc_tpu/utils/profiling.py`).

`profiled_function` and `record_function` name a span in a
`torch.profiler` trace; `trace` captures one and writes it as a Chrome
trace (chrome://tracing, Perfetto); `count_params` and
`print_params_summary` count the parameters of a params tree (nested dicts
of tensors or arrays) or of an `nn.Module`.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Iterator, List

import numpy as np
import torch

from ..device import DeviceLike


def profiled_function(fn: Callable) -> Callable:
    """Run `fn` inside a profiler span named after it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def record_function(name: str):
    """A named profiler span."""
    with torch.profiler.record_function(name):
        yield


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
