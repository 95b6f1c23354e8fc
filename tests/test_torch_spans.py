"""The port's span recorder (`utils/profiling.py`) and the spans the
dispatcher, the editing service and the training loop record with it, on
the CPU."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from stylemc_torch.cli.serve import EditService
from stylemc_torch.serve import CoalescingDispatcher
from stylemc_torch.train import find_direction as fd
from stylemc_torch.utils import profiling as prof
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def recording():
    prof.start_recording()
    yield prof
    prof.stop_recording()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_attributes_and_self_time(recording):
    @prof.profiled_function(name="outer")
    def outer():
        with prof.record_function("inner", request=7, rows=3) as sid:
            assert prof.current_span() == sid
            time.sleep(0.02)
        time.sleep(0.01)
        return sid

    inner_id = outer()
    assert prof.current_span() is None
    spans = _by_name(prof.drain_spans())
    (o,), (i,) = spans["outer"], spans["inner"]
    assert i.id == inner_id and i.parent == o.id and o.parent is None
    assert i.request == 7 and i.attrs == {"rows": 3}
    assert o.start_ns <= i.start_ns < i.end_ns <= o.end_ns
    assert i.thread == o.thread == threading.get_native_id()
    own = prof.self_ns([o, i])
    assert own[i.id] == i.end_ns - i.start_ns
    assert own[o.id] == (o.end_ns - o.start_ns) - (i.end_ns - i.start_ns)
    assert own[o.id] >= 0.009e9
    assert prof.drain_spans() == []


def test_spans_from_many_threads_keep_their_own_parents(recording):
    switch = sys.getswitchinterval()

    def work(k):
        with prof.record_function("job", request=k):
            for step in range(50):
                with prof.record_function("step", step=step):
                    pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    spans = _by_name(prof.drain_spans())
    jobs = {s.id: s for s in spans["job"]}
    assert len(jobs) == 8 and len(spans["step"]) == 400
    assert len({s.id for s in spans["step"]} | set(jobs)) == 408
    for s in spans["step"]:
        parent = jobs[s.parent]
        assert parent.thread == s.thread
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert sorted(len([s for s in spans["step"] if s.parent == j])
                  for j in jobs) == [50] * 8


def test_nothing_is_recorded_while_off():
    assert prof.stop_recording() == 0
    with prof.record_function("off", rows=1) as sid:
        assert sid is None and prof.current_span() is None
    prof.add_span("off", 0, 1, 0)
    assert prof.drain_spans() == []
    prof.start_recording()
    assert prof.drain_spans() == []     # the earlier spans did not wait
    prof.stop_recording()


def test_the_buffer_is_bounded(recording, monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    prof.start_recording()
    for k in range(5):
        with prof.record_function("s", k=k):
            pass
    assert [s.attrs["k"] for s in prof.drain_spans()] == [0, 1, 2]
    with prof.record_function("s", k=5):
        pass
    assert [s.attrs["k"] for s in prof.drain_spans()] == [5]
    assert prof.stop_recording() == 2


def test_host_data_reaches_the_device_in_a_copy_span(recording):
    """`to_device` is `torch.as_tensor`, one `copy.h2d` span a call inside
    the caller's span."""
    f = np.array([1, 3, 3, 1], np.float32)
    with prof.record_function("outer") as outer:
        t = prof.to_device(f, "cpu", torch.float16)
        rows = prof.to_device([4, 5], torch.device("cpu"))
    assert torch.equal(t, torch.as_tensor(f, dtype=torch.float16))
    assert rows.dtype == torch.int64 and rows.tolist() == [4, 5]
    copies = _by_name(prof.drain_spans())["copy.h2d"]
    assert [s.parent for s in copies] == [outer, outer]


def test_dispatcher_waits_end_where_their_call_starts(recording):
    """Requests merged into one call share its id; a second key's group,
    drained with them, waits for the first group's call."""
    release = threading.Event()

    def slow(rows):
        release.wait(5)
        return rows * 10

    disp = CoalescingDispatcher(max_batch=64, max_wait_ms=300.0)
    out = {}

    def submit(k, key):
        with prof.record_function("request", request=k):
            out[k] = disp.submit(key, np.array([k]), slow, request=k)

    threads = [threading.Thread(target=submit, args=(k, "a" if k < 3
                                                     else "b"))
               for k in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    release.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    disp.close()
    assert {k: int(v[0]) for k, v in out.items()} == {
        0: 0, 1: 10, 2: 20, 3: 30}
    spans = _by_name(prof.drain_spans())
    calls = {s.id: s for s in spans["dispatch.call"]}
    waits = {s.request: s for s in spans["dispatch.wait"]}
    requests = {s.request: s for s in spans["request"]}
    assert len(calls) == 2 and set(waits) == {0, 1, 2, 3}
    first = next(c for c in calls.values() if c.attrs["key"] == 0)
    second = next(c for c in calls.values() if c.attrs["key"] == 1)
    assert sorted(first.attrs["requests"]) == [0, 1, 2]
    assert second.attrs["requests"] == (3,) and second.attrs["rows"] == 1
    for k, w in waits.items():
        call = calls[w.attrs["call"]]
        assert k in call.attrs["requests"]
        assert w.end_ns <= call.start_ns < w.end_ns + 5e6
        # the submitter's span holds its wait and its call
        assert w.parent == requests[k].id and w.thread == requests[k].thread
        assert requests[k].start_ns <= w.start_ns
        assert call.end_ns <= requests[k].end_ns
    assert waits[3].end_ns >= first.end_ns
    (drain,) = spans["dispatch.drain"]
    assert drain.end_ns <= first.start_ns
    assert len(disp.wait_ms()) == 4 and disp.wait_ms().min() >= 0


def test_service_keeps_the_last_thousand_latencies():
    svc = EditService(editor=None)
    for _ in range(1005):
        svc._timed(lambda request: np.zeros(1))
    stats = svc.stats()
    assert stats["requests"] == 1005 and len(svc._latencies) == 1000
    assert "p50_ms" in stats and "queue_wait_p50_ms" not in stats


def test_a_job_is_covered_by_its_step_sync_and_callback_spans(recording):
    """One train.step per step, with its number and prompts; the loop's
    spans cover the job's time, and its clock is the recorder's."""
    cfg = fd.FindDirectionConfig(batch_size=2, n_epochs=2)

    def step(delta, idx, lr):
        time.sleep(0.02)
        return delta + 1, torch.ones(()), {}, torch.zeros(())

    def after_step(it, total, lr, idx, delta, loss, aux, grad_norm):
        time.sleep(0.002)

    with prof.record_function("train.job"):
        delta, hist, info = fd._sgd_loop(torch.zeros(3), step, 5, cfg,
                                         after_step, prompts=2)
    assert info["iterations"] == 6 and hist.shape == (6,)
    spans = _by_name(prof.drain_spans())
    (job,) = spans["train.job"]
    steps = spans["train.step"]
    assert [s.attrs["step"] for s in steps] == list(range(1, 7))
    assert {s.attrs["prompts"] for s in steps} == {2}
    assert len(spans["train.callback"]) == 6 and len(spans["train.sync"]) == 2
    children = spans["train.step"] + spans["train.sync"] + \
        spans["train.callback"]
    assert all(s.parent == job.id for s in children)
    # each step's batch indices reach the device inside it
    assert [s.parent for s in spans["copy.h2d"]] == [s.id for s in steps]
    covered = sum(s.end_ns - s.start_ns for s in children)
    assert covered >= 0.95 * (job.end_ns - job.start_ns)
    assert info["time"] * 1e9 <= job.end_ns - job.start_ns
    assert info["time"] * 1e9 >= covered
