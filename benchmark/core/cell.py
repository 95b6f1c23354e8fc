"""A cell, found by name: its entry in BENCHMARK.json, its configuration
file, its traffic file and the traffic's driver, its correctness limits
and the readers of its metrics. Everything that belongs to one
configuration, traffic mix, cell or metric sits in a file of its own under
`benchmark/`, named after it; adding one means adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module from a file whose name may hold dots (metric readers)."""
    name = "benchmark_file_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    @property
    def driver(self) -> ModuleType:
        return importlib.import_module(
            f"benchmark.drivers.{self.traffic['kind']}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")


def reports(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """Whether `cell` reports `metric`: the cell is listed under its
    `workloads`; without the key, every cell reports an end-to-end metric,
    and every cell that reports the end-to-end metric a per-layer metric
    moves reports that one."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / "benchmark"
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(entries)}")
    entry = entries[name]
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name=name, entry=entry,
                config=load_json(root / config["file"]),
                traffic=load_json(bench_dir / "traffic" /
                                  f"{entry['traffic']}.json"),
                limits=load_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)
