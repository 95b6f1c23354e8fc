"""Device timing, the card's state, and the profiler over a traced window.

`card_state` is the benchmark's own copy of the port's helper; `Trace`
keeps the retry of the port's profiled calls: a trace that missed device
events is taken again on the next stretch of work. A probe's device time
is the profiler's busy time (`busy_ms`): CUDA events behind a sleep kernel
(the port's `device_ms`) cannot time a call that launches more kernels
than the launch queue holds while the sleep kernel runs.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Optional, Tuple

import torch

CARD_STATE = ("name", "power.limit", "clocks.sm", "clocks.max.sm",
              "power.draw", "temperature.gpu")


def card_state() -> Dict:
    """The first card's name, power limit (W), SM clock and its maximum
    (MHz), power draw (W) and temperature (C), as nvidia-smi reads them;
    {} where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(CARD_STATE),
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    state = {}
    for key, value in zip(CARD_STATE, out.strip().splitlines()[0].split(",")):
        value = value.strip()
        try:
            state[key] = float(value)
        except ValueError:
            state[key] = value
    return state


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start takes seconds,
    which a traced stretch must not pay."""
    tr = Trace()
    tr.start()
    torch.zeros(1, device="cuda").add_(1)
    tr.stop()


def busy_ms(fn, calls: int = 3) -> float:
    """Device time per call of `fn` from the profiler: the kernels and
    copies of `calls` calls after a warm one, overlaps merged, over
    `calls`. Unlike `device_ms` it holds for calls that launch more
    kernels than the launch queue takes behind a sleep kernel."""
    fn()
    tr = Trace()
    tr.start()
    for _ in range(calls):
        fn()
    tr.stop()
    return 1e3 * tr.busy_s / calls


class Trace:
    """The profiler over one stretch of work: `start()`, the work, `stop()`
    after a synchronise. `valid` is False where the trace holds under 5 %
    of the window in device time (the profiler missed events); the caller
    then traces its next stretch, and may hold the kernel counts to what
    the stretch launches. After `stop()`: busy_s, window_s, kernels
    {name: [seconds, calls]}, gaps [[label, seconds], ...]."""

    def __init__(self):
        self._prof = None
        self.busy_s = self.window_s = 0.0
        self.kernels: Dict[str, List] = {}
        self.gaps: List[Tuple[str, float]] = []

    def start(self, sync: bool = True) -> None:
        from torch.profiler import ProfilerActivity, profile

        if sync:
            torch.cuda.synchronize()
        # the device's activity and the CUDA calls alone: recording every
        # host op doubles a host-bound training step
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, sync: bool = True, read: bool = True) -> None:
        """End the stretch; without `sync` the stretch ends as the host
        reaches it, and without `read` the events are read by `read()`
        later (an open loop's sender cannot wait for either)."""
        if sync:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        if read:
            self.read()

    def read(self) -> None:
        self._read(self._prof)
        self._prof = None

    @property
    def running(self) -> bool:
        return self._prof is not None and not self.window_s

    @property
    def valid(self) -> bool:
        return self.busy_s > 0.05 * self.window_s

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType

        device, host = [], []
        for evt in prof.events():
            tr = evt.time_range
            if evt.device_type == DeviceType.CUDA:
                device.append((tr.start, tr.end, evt.name))
            else:
                host.append((tr.start, tr.end, evt.name))
        device.sort()
        merged: List[List[float]] = []
        for s, e, name in device:
            rec = self.kernels.setdefault(name, [0.0, 0])
            rec[0] += (e - s) / 1e6
            rec[1] += 1
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        self.gaps = [(self._host_at(host, at), length / 1e6)
                     for length, at in gaps]

    @staticmethod
    def _host_at(host, at: float) -> str:
        """The CUDA call the host was in at `at` (us), the innermost where
        several were; 'host: no CUDA call' where none was (Python and
        framework work)."""
        best: Optional[Tuple[float, str]] = None
        for s, e, name in host:
            if s <= at <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host: no CUDA call"

    def breakdown(self) -> Dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name[:120], rec[0]] for name, rec in top],
                "idle_gaps": [[label, s] for label, s in self.gaps]}

    def kernel_seconds(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and calls of the kernels whose name holds
        `fragment`."""
        secs = calls = 0
        for name, (s, n) in self.kernels.items():
            if fragment in name:
                secs += s
                calls += n
        return secs, calls
