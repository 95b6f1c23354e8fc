"""One run of one cell: set-up, the measured window, the probes of a
traced run, the memory peak, the program's state freed, then the
comparison with the plain reference that decides `correct`.

A driver module (`benchmark/drivers/<kind>.py`) gives
  setup(ctx) -> state              everything before the window, warm-up
                                   of the cell's own shapes included
  window(ctx, state) -> record     the measured window; with ctx.trace
                                   also record["trace"] (a timing.Trace)
  release(ctx, state) -> inputs    drops the program's objects and returns
                                   what the benchmark made for the
                                   reference (weights, seeds, photos)
  check(ctx, inputs, outputs) -> {number: value}
                                   the numbers compared, `outputs` being
                                   record["outputs"]
  control(ctx, inputs, outputs) -> outputs
                                   the reference at the control's lower
                                   precision put in the program's place
                                   (benchmark/calibrate.py)
A metric reader (`benchmark/metrics/<metric>.py`) gives read(ctx, record)
-> value or None, and optionally probe(ctx, state) -> dict, which a traced
run calls after the window; its result is record["probes"][metric].
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Any, Dict, Optional

import torch

from .cell import Cell
from .precision import set_precision
from .timing import warm_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "stylemc_tpu")


def forbidden_modules(names=None) -> list:
    """Of `names` (by default the loaded modules), the top-level names,
    compared whole, that are JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic


def _finite_below(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> Dict:
    """→ the result line's object, "compared" last."""
    ctx = Ctx(cell, seed, seconds, trace, device)
    driver = cell.driver
    set_precision(cell.config)
    cuda = device.type == "cuda"
    if trace:
        warm_profiler()
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    record = driver.window(ctx, state)
    record["setup_s"] = setup_s
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        record["probes"] = {}
        for m in cell.per_layer:
            reader = cell.reader(m["name"])
            if hasattr(reader, "probe"):
                record["probes"][m["name"]] = reader.probe(ctx, state)
    names = [m["name"] for m in (cell.per_layer if trace else
                                 cell.end_to_end)]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(ctx, record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log("metrics " + " ".join(f"{k}={v['value']}" for k, v in
                              metrics.items()) + f" (of {names})")
    outputs = record.pop("outputs")
    trace_obj: Optional[Any] = record.get("trace")
    inputs = driver.release(ctx, state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = driver.check(ctx, inputs, outputs)
    log(f"reference check {time.perf_counter() - t_check:.3f} s")
    compared = {name: {"value": float(value),
                       "limit": float(cell.limits[name]["limit"])}
                for name, value in readings.items()}
    correct = record["failed"] == 0 and all(
        _finite_below(c["value"], c["limit"]) for c in compared.values())
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if cuda else "cpu",
                         "count": cell.entry["chips"],
                         "memory_peak_bytes": memory_peak}}
    if trace and trace_obj is not None:
        result["device"]["busy_s"] = trace_obj.busy_s
        result["device"]["window_s"] = trace_obj.window_s
        result["breakdown"] = trace_obj.breakdown()
    result["compared"] = compared
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded modules of JAX or the JAX package: "
                         + ", ".join(names))
        self.names = names
