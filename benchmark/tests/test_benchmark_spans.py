"""The program_span metrics: their readers on synthetic spans, the clock
anchors' arithmetic and the idle gaps' labels on synthetic profiler events,
and a tiny run of each cell that reads them on the CPU."""

import math
from pathlib import Path

import numpy as np
import pytest

from benchmark.core import spans
from benchmark.core.cell import load_module
from benchmark.core.precision import set_precision
from benchmark.core.runner import Ctx
from benchmark.tests.tiny_cells import cpu, tiny_cell
from stylemc_torch.utils.profiling import Span

SEED = 2 ** 31 + 77
MS = 1_000_000
METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _span(name, start_ms, end_ms, thread=1, id=0, parent=None, request=None,
          **attrs):
    return Span(name, int(start_ms * MS), int(end_ms * MS), thread, id,
                parent, request, attrs)


def _read(metric, rep):
    return load_module(METRICS / f"{metric}.py").read(
        None, {"probes": {metric: rep}})


def test_serve_readers_on_synthetic_spans():
    waits = [_span("dispatch.wait", 100 * k, 100 * k + w, request=k)
             for k, w in enumerate([1, 2, 3, 4, 50, 6, 7, 8, 9, 10])]
    calls = [_span("dispatch.call", 0, 250), _span("dispatch.call", 500, 750),
             _span("dispatch.call", 900, 1100)]
    rep = spans.Replay(waits + calls, (0, 1000 * MS), [], attempted=10,
                       dropped=0)
    assert _read("serve.queue_wait_p95_ms", rep) == pytest.approx(
        np.percentile([1, 2, 3, 4, 50, 6, 7, 8, 9, 10], 95))
    # clipped to the window: 250 + 250 + 100 of 1000 ms
    assert _read("serve.worker_busy_share", rep) == pytest.approx(60.0)
    # a submission no call carried reads infinite; a profiled stretch
    # takes the waits that overlap it and its time out
    rep = spans.Replay(waits[:8] + calls, (0, 1000 * MS),
                       [(400 * MS, 600 * MS)], attempted=10, dropped=0)
    assert _read("serve.queue_wait_p95_ms", rep) == math.inf
    assert len(rep.kept("dispatch.wait")) == 6
    assert _read("serve.worker_busy_share", rep) == pytest.approx(
        100 * (250 + 150 + 100) / 800)
    assert _read("serve.queue_wait_p95_ms", None) is None


def test_train_readers_on_synthetic_spans():
    steps = [_span("train.step", 100 + 10 * k, 108 + 10 * k, step=k + 1,
                   prompts=4) for k in range(20)]
    steps[0] = _span("train.step", 100, 190, step=1, prompts=4)
    # a 2 ms copy to the device inside each step; 1 ms copies on another
    # thread inside 11 of the 19 steps counted
    copies = [_span("copy.h2d", 101 + 10 * k, 103 + 10 * k)
              for k in range(1, 20)]
    others = [_span("copy.h2d", 105 + 10 * k, 106 + 10 * k, thread=2)
              for k in range(2, 13)]
    rep = spans.Replay(
        steps + copies + others + [
            _span("train.prologue", 0, 100), _span("train.sync", 300, 310),
            _span("train.sync", 995, 1005), _span("train.job", 0, 1005)],
        (0, 1000 * MS), [], attempted=80, dropped=0)
    # the first step is left out; 8 ms a step of 4 prompts, 2 ms of it a
    # wait on the device on the step's own thread
    assert _read("train.step_host_ms", rep) == pytest.approx(1.5)
    assert _read("train.prologue_share", rep) == pytest.approx(10.0)
    # 10 + 5 ms of train.sync in the window, 38 + 11 ms of copies
    assert _read("train.sync_share", rep) == pytest.approx(6.4)


def test_anchor_offsets_and_their_error():
    # host clock = profiler clock (us) * 1000 + 5e9, each call 2 us
    brackets = [(5_000_010_000 + 100 * k, 5_000_013_000 + 100 * k)
                for k in range(3)]
    events = [(11.0 + 0.1 * k, 12.0 + 0.1 * k) for k in range(3)]
    offset, error = spans.offset_from(brackets, events)
    assert abs(offset - 5e9) <= error <= 1000
    # pairs that ask for offsets 1 us apart disagree: a negative error
    assert spans.offset_from([(0, 10), (2000, 2010)],
                             [(0.0, 0.005), (1.0, 1.005)])[1] < 0


def test_gap_labels_name_the_span_that_covers_most_of_each_gap():
    tr = spans.AnchoredTrace()
    tr.offset_ns = 1e9
    # device busy [0, 10], [30, 40], [41, 42], [80, 90] us
    tr.idle_us = [(10.0, 30.0), (40.0, 41.0), (42.0, 80.0)]
    tr._host = [(9.0, 12.0, "cudaEventSynchronize")]
    at = lambda us: int(1e9 + us * 1e3)  # noqa: E731
    sp = [Span("dispatch.call", at(0), at(29), 7, 1, None, None, {}),
          Span("editor.fetch", at(8), at(28), 7, 2, 1, None, {}),
          Span("dispatch.drain", at(44), at(48), 7, 3, None, None, {}),
          Span("serve.request", at(0), at(100), 9, 4, None, None, {})]
    labels = tr.labelled_gaps(sp, top=2)
    # longest first: the worker holds no span over 34 of the 38 us; the
    # fetch is the innermost span over 18 of the 20; the sender's request
    # is on no device thread
    assert labels == [["host: no CUDA call @ no span", 38e-6],
                      ["cudaEventSynchronize @ editor.fetch", 20e-6]]
    idle = tr.idle_by_span(sp)
    assert idle["serve.request"] == pytest.approx(59e-6)
    assert idle["editor.fetch"] == pytest.approx(18e-6)


@pytest.mark.parametrize("name, metrics", [
    ("ffhq256.find_direction", ["train.step_host_ms", "train.sync_share",
                                "train.prologue_share"]),
    ("ffhq256.sweep4", ["train.step_host_ms", "train.sync_share",
                        "train.prologue_share"]),
    ("ffhq256.edit_open", ["serve.queue_wait_p95_ms",
                           "serve.worker_busy_share"]),
])
def test_a_tiny_run_reads_every_program_span_metric(name, metrics):
    cell = tiny_cell(name)
    assert [m["name"] for m in cell.per_layer
            if m["source"] == "program_span"] == metrics
    set_precision(cell.config)
    ctx = Ctx(cell, SEED, 0.5, True, cpu())
    state = cell.driver.setup(ctx)
    record = {"probes": {m: cell.reader(m).probe(ctx, state)
                         for m in metrics}}
    values = {m: cell.reader(m).read(ctx, record) for m in metrics}
    assert all(np.isfinite(v) and v >= 0 for v in values.values()), values
    rep = record["probes"][metrics[0]]
    assert rep.dropped == 0 and not rep.excluded
    cell.driver.release(ctx, state)
