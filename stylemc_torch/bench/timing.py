"""Device timing and the card's identity, for the port's measurements."""

from __future__ import annotations

import subprocess
import time

import torch


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (first
    card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


CARD_STATE = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")


def card_state() -> dict:
    """The first card's SM clock and its maximum (MHz), power draw (W) and
    temperature (C) as nvidia-smi reads them now. Read before and after a
    timed window, they tell a card that ran slow from code that did."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(CARD_STATE),
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    state = {}
    for key, value in zip(CARD_STATE, out.strip().splitlines()[0].split(",")):
        try:
            state[key] = float(value)
        except ValueError:
            state[key] = value.strip()
    return state


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of `fn` (which must not synchronise): CUDA
    events around `iters` calls queued behind a sleep kernel, so the host's
    launch cost is hidden and the events time the device's work alone,
    gaps between kernels included. The sleep grows until it outlasts the
    queuing."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if marks[0].elapsed_time(marks[1]) > 1.5 * queued_ms:
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 4
    raise RuntimeError("the calls could not be queued behind a sleep "
                       "kernel; does the function synchronise?")


def device_ms_for(fn, target_ms: float = 15.0) -> float:
    """`device_ms` of `fn` over as many calls (3..12) as fill about
    `target_ms`, from one call timed with CUDA events. At most 12 calls: a
    fwd+bwd call launches ~45 kernels, and all of them wait in the
    stream's queue behind the sleep kernel."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    est_ms = max(start.elapsed_time(end), 1e-3)
    return device_ms(fn, iters=max(3, min(12, int(target_ms / est_ms))))
