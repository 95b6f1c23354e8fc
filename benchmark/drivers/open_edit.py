"""Open-loop seed edits through the editing service.

`stylemc_torch.cli.serve.EditService.edit` with the CLI's coalescing
dispatcher over a `BatchEditor`, driven by independent users: requests are
due on a schedule fixed in advance and each is sent by a thread of its own
at its due time, whatever the service is doing. The arrivals are one
Poisson schedule fixed by the traffic file (`schedule_seed`): gaps at the
quantiles of an exponential at the traffic's rate, request sizes and
directions in their exact shares, in one shuffled order; the run's seed
draws the z seeds each request edits. (With the order drawn from the run's
seed, the order alone moved the p95 by a third between seeds.) Latency runs
from a request's due time to its answer, so a stall counts against every
request it delays; requests that fail or never answer count as missing.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..core import compare, models as core_models, precision, timing
from ..reference import stylegan2
from . import program


def _exact(rng, pairs, n: int) -> np.ndarray:
    """n draws of pairs [(value, share)]: each value as many times as its
    share of n (largest remainders), in the rng's order."""
    values = [v for v, _ in pairs]
    raw = np.array([s for _, s in pairs], float) * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts))[:n - counts.sum()]:
        counts[i] += 1
    out = np.repeat(np.arange(len(values)), counts)
    return np.array(values, dtype=object)[rng.permutation(out)]


def schedule(traffic: Dict[str, Any], seconds: float, seed: int
             ) -> List[Dict[str, Any]]:
    """The window's requests: due (s from the start) and direction from the
    traffic's fixed schedule, z seeds from the run's seed."""
    rate = traffic["rate_per_s"]
    n = max(1, round(rate * seconds))
    rng = program.seeded_rng(traffic["schedule_seed"], "schedule")
    sizes = _exact(rng, traffic["seeds_per_request"], n)
    names = _exact(rng, traffic["directions"], n)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])
    z_seeds = program.seeded_rng(seed, "z seeds").integers(
        0, 2 ** 31 - 1, size=int(sum(sizes)))
    out, at = [], 0
    for i in range(n):
        k = int(sizes[i])
        out.append({"due": float(due[i]), "direction": str(names[i]),
                    "seeds": [int(s) for s in z_seeds[at:at + k]]})
        at += k
    return out


def check_set(requests, count: int, seed: int) -> List[int]:
    """Requests whose answers the reference checks: the largest first,
    then a seeded draw of the rest."""
    rng = program.seeded_rng(seed, "check")
    largest = max(range(len(requests)),
                  key=lambda i: len(requests[i]["seeds"]))
    rest = [i for i in rng.permutation(len(requests)) if i != largest]
    return sorted([largest] + rest[:count - 1])


def setup(ctx) -> Dict[str, Any]:
    from stylemc_torch.cli.serve import EditService
    from stylemc_torch.serve import BatchEditor

    t = ctx.traffic
    models = core_models.make_models(ctx.config, ctx.seed, ctx.device)
    names = [name for name, _ in t["directions"]]
    dirs = program.directions(ctx.seed, names, t["direction_scale"],
                              ctx.device)
    editor = BatchEditor(program.generator_config(ctx.config["generator"]),
                         models["generator"], max_batch=t["max_batch"],
                         truncation_psi=ctx.config["truncation_psi"],
                         precision=t["precision"],
                         pipeline_chunk=t["pipeline_chunk"],
                         device=ctx.device)
    for name, d in dirs.items():
        editor.add_direction(name, d.cpu().numpy())
    # the cell's shapes: mapping buckets to max_batch, render chunks
    for rows in t["warmup_rows"]:
        editor.edit_seeds(list(range(rows)), change_power=t["power"],
                          pairs=t["pairs"], direction_name=names[0])
    service = EditService(editor, coalesce_ms=t["coalesce_ms"],
                          max_batch=t["max_batch"])
    requests = schedule(t, ctx.seconds, ctx.seed)
    return {"models": models, "directions": dirs, "editor": editor,
            "service": service, "requests": requests,
            "check": set(check_set(requests, t["check_requests"], ctx.seed))}


def window(ctx, state) -> Dict[str, Any]:
    t = ctx.traffic
    service = state["service"]
    requests = state["requests"]
    lat = [math.inf] * len(requests)
    late = [0.0] * len(requests)
    outputs: Dict[int, Any] = {}
    rec: Dict[str, Any] = {}
    calls_before = service.stats()["batched_calls"]

    def send(i, due_at):
        r = requests[i]
        out = service.edit(r["seeds"], t["power"], t["pairs"],
                           direction_name=r["direction"])
        lat[i] = time.perf_counter() - due_at
        if i in state["check"]:
            outputs[i] = out.copy()
        return out.shape[0]

    # the profiler runs from this thread (it must be started and stopped
    # on one thread) over stretches of trace_s from trace_from_s, every
    # trace_every_s, without a drain; after the window the first that
    # caught the device's kernels is kept (one can miss them)
    traces = [timing.Trace() for _ in range(t["trace_tries"])] \
        if ctx.trace else []
    marks = sorted((t["trace_from_s"] + k * t["trace_every_s"] + end
                    * t["trace_s"], k, end)
                   for k in range(len(traces)) for end in (0, 1))
    t0 = time.perf_counter()
    futures = []
    with cf.ThreadPoolExecutor(max_workers=t["senders"]) as pool:
        for i, r in enumerate(requests):
            due_at = t0 + r["due"]
            pause = due_at - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            late[i] = time.perf_counter() - due_at
            futures.append(pool.submit(send, i, due_at))
            while marks and time.perf_counter() - t0 >= marks[0][0]:
                _, k, end = marks.pop(0)
                if end:
                    traces[k].stop(sync=False, read=False)
                else:
                    traces[k].start(sync=False)
        window_s = time.perf_counter() - t0
        for _, k, end in marks:
            if end and traces[k].running:   # a stretch the window cut
                traces[k].stop(sync=False, read=False)
        done, _ = cf.wait(futures, timeout=t["wait_after_s"])
        images = sum(f.result() for f in done if f.exception() is None)
        failed = len(futures) - sum(1 for f in done
                                    if f.exception() is None)
        for f in done:
            if f.exception() is not None:
                print(f"request failed: {f.exception()!r}", file=sys.stderr)
    read = [tr for tr in traces if tr.window_s]
    for tr in read:
        tr.read()
    if read:   # the first that caught the kernels, else the fullest
        rec["trace"] = next((tr for tr in read if tr.valid),
                            max(read, key=lambda tr: tr.busy_s))
    calls = service.stats()["batched_calls"] - calls_before
    ms = np.asarray(lat) * 1e3
    print(f"edit latency p50 {np.percentile(ms, 50):.3f} ms, "
          f"p95 {np.percentile(ms, 95):.3f} ms over {len(ms)} requests; "
          f"sender late p50 {np.median(late) * 1e3:.3f} ms, "
          f"max {max(late) * 1e3:.3f} ms; {images} images in {calls} calls",
          file=sys.stderr)
    rec.update(window_s=window_s, latencies_ms=ms, images=images,
               batched_calls=calls, attempted=len(requests), failed=failed,
               sender_late_ms=np.asarray(late) * 1e3,
               outputs={i: (requests[i], outputs.get(i))
                        for i in state["check"]})
    return rec


def release(ctx, state) -> Dict[str, Any]:
    state["service"].close()
    return {"models": state["models"], "directions": state["directions"]}


def reference_levels(ctx, inputs, request, tf32: bool = False
                     ) -> torch.Tensor:
    """The reference's unrounded uint8 levels of one request's edits."""
    g = ctx.config["generator"]
    gp = inputs["models"]["generator"]
    dev = gp["mapping"]["w_avg"].device
    z = torch.as_tensor(np.concatenate(
        [np.random.RandomState(s).randn(1, g["z_dim"])
         for s in request["seeds"]]).astype(np.float32), device=dev)
    with precision.tf32(tf32), torch.no_grad():
        styles = stylegan2.w_to_s(gp, g, stylegan2.mapping(
            gp, g, z, ctx.config["truncation_psi"]))
        styles = styles + inputs["directions"][request["direction"]] \
            * ctx.traffic["power"]
        return stylegan2.to_levels(stylegan2.synthesis(gp, g, styles))


def control(ctx, inputs, outputs) -> Dict[int, Any]:
    """The reference at TF32, truncated to bytes, in the program's place."""
    return {i: (req, compare.truncate_levels(
        reference_levels(ctx, inputs, req, tf32=True)).cpu().numpy())
        for i, (req, _) in outputs.items()}


def check(ctx, inputs, outputs) -> Dict[str, float]:
    """render_gap: the widest gap over every value of the checked
    requests' edits (a request that never answered reads infinite)."""
    worst = 0.0
    for req, served in outputs.values():
        if served is None:
            return {"render_gap": math.inf}
        levels = reference_levels(ctx, inputs, req)
        worst = max(worst, compare.render_gap(levels, torch.as_tensor(
            served)))
    return {"render_gap": worst}
