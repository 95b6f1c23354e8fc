"""Training-stat collection across processes (counterpart of
`stylemc_tpu/parallel/stats.py`).

Scalar stats accumulate as float64 moment triples [count, sum, sum of
squares] on the host (`report`); a `Collector` exposes their mean and std,
and `update(cross_process=True)` sums every stat's triple over the
torch.distributed process group in one all-reduce.
"""

from __future__ import annotations

import collections
import re
from typing import Dict

import numpy as np
import torch

from .mesh import all_reduce_sum, process_count, process_index

_counters: Dict[str, np.ndarray] = collections.defaultdict(
    lambda: np.zeros(3, np.float64))


def moments(value) -> torch.Tensor:
    """[count, sum, sum_sq] of a tensor's float32 values, as float32."""
    v = torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value).detach().to(torch.float32).reshape(-1)
    return torch.stack([torch.tensor(float(v.numel()), device=v.device),
                        v.sum(), v.square().sum()])


def report(name: str, value) -> None:
    """Add a value's moments to the stat `name`."""
    _counters[name] += moments(value).cpu().numpy().astype(np.float64)


def report0(name: str, value) -> None:
    """`report` on process 0 only."""
    if process_index() == 0:
        report(name, value)


class Collector:
    """Mean/std view over the accumulated stats whose name matches
    `regex`."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self.update()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self, cross_process: bool = False):
        """Move the counters into the collector; with cross_process, each
        stat's triple is first summed over the process group (every
        process must hold the same stat names)."""
        if not self._keep_previous:
            self._moments.clear()
        names = self.names()
        taken = []
        for name in names:
            taken.append(_counters[name].copy())
            _counters[name][:] = 0
        if cross_process and process_count() > 1 and taken:
            summed = all_reduce_sum([torch.from_numpy(np.stack(taken))])[0]
            taken = list(summed.numpy())
        for name, m in zip(names, taken):
            if name in self._moments:
                self._moments[name] += m
            else:
                self._moments[name] = m

    def num(self, name: str) -> int:
        return int(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        if m[0] == 1:
            return 0.0
        mean = m[1] / m[0]
        var = max(m[2] / m[0] - mean * mean, 0.0)
        return float(np.sqrt(var))

    def as_dict(self):
        return {n: {"num": self.num(n), "mean": self.mean(n),
                    "std": self.std(n)} for n in self._moments}
