"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of cells by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.core.cell import ROOT, load_cell
from benchmark.core.runner import forbidden_modules

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["workloads"]) <= 24
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS + [
    c["name"] for c in BENCH["configs"]])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_keys(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in BENCH["end_to_end"] else \
        {"layer", "moves"}
    assert set(metric) <= allowed
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").exists()
    # no metric is left listing no cell, and each lists only cells there are
    assert metric.get("workloads", CELLS)
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_what_its_cells_report(metric):
    assert metric["workloads"], metric["name"]
    for cell in metric["workloads"]:
        e2e = [m["name"] for m in load_cell(cell).end_to_end]
        assert metric["moves"] in e2e, (metric["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_its_files_and_reports_enough(name):
    cell = load_cell(name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert cell.entry["chips"] == 1
    assert len(cell.entry["why"]) <= 200
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    assert cell.driver.setup and cell.driver.check and cell.driver.control


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_are_files_under_paths(config):
    assert config["file"].startswith("benchmark/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"] == []
    assert data["tf32"] is False and data["precision"] == "float32"
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_the_file_is_small_and_single_line_fields():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200
                assert "\n" not in entry[key] and "\t" not in entry[key]


def test_a_cell_added_as_files_is_found_without_code(tmp_path):
    """A new mix is a traffic file, a limits file and an entry: the
    harness finds its driver, readers and limits by name."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (root / "benchmark/traffic/edit_open.json").read_text())
    traffic.update(seeds_per_request=[[1, 1.0]], rate_per_s=7.0)
    (root / "benchmark/traffic/edit_single.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/limits/ffhq256.edit_single.json").write_text(
        (root / "benchmark/limits/ffhq256.edit_open.json").read_text())
    bench["workloads"].append({"name": "ffhq256.edit_single",
                               "config": "ffhq256", "traffic": "edit_single",
                               "chips": 1, "why": "one seed a request"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ffhq256.edit_open" in m.get("workloads", []):
            m["workloads"].append("ffhq256.edit_single")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("ffhq256.edit_single", root=root)
    assert cell.traffic["rate_per_s"] == 7.0
    assert cell.driver.__name__ == "benchmark.drivers.open_edit"
    assert {m["name"] for m in cell.end_to_end} == {"edit_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "serve.rows_per_call", "synthesis_roofline.serve", "serve.mfu"}
    for m in cell.per_layer:
        assert cell.reader(m["name"]).read


@pytest.mark.parametrize("names, found", [
    (["jax.numpy", "torch"], ["jax"]),
    (["stylemc_tpu.models.stylegan2"], ["stylemc_tpu"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["stylemc_torch.models", "stylemc_torch", "jaxtyping", "jax_utils"], []),
])
def test_the_no_jax_check_compares_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def test_nothing_under_the_benchmark_reads_the_jax_side_or_the_smoke():
    pattern = re.compile(r"\b(import|from)\s+(jax|jaxlib|flax|stylemc_tpu)\b"
                         r"|chip_smoke|\bbench\.py|\.bench/"
                         r"|BENCH_r\d|MULTICHIP_r\d"
                         r"|stylemc_torch\.bench")
    for path in (ROOT / "benchmark").rglob("*.py"):
        if path.name.startswith("test_benchmark_contract"):
            continue
        assert not pattern.search(path.read_text()), path


def test_the_reference_imports_nothing_of_the_program():
    program = re.compile(r"(import|from)\s+(stylemc_torch|\.\.drivers)")
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert not program.search(path.read_text()), path
