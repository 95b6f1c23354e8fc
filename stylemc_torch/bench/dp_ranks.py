"""One process of a torch.distributed group on the data-parallel paths,
and its three checks:

  a) one `find_direction` step with the batch split over the group (each
     process its block of rows, over its own mesh of `shards` devices),
     read against reference runs of the full batch in one process;
  b) `FeatureStats.append_multihost`: every process's rows, process-major;
  c) `stats.Collector(cross_process=True)`: the moments of the union of
     each process's reports.

    python -m stylemc_torch.bench.dp_ranks SPEC RANK WORLD PORT OUT_JSON
    python -m stylemc_torch.bench.dp_ranks --probe BACKEND RANK WORLD PORT

SPEC is a pickle written by `write_spec`: the generator (a native .npz),
the CLIP towers and ArcFace (numpy trees, or an int seed for a seeded
full-width tower), the styles, the FindDirectionConfig fields, the resume
direction, the device, the shards per process, the backend (gloo or nccl)
and the references with their tolerances. --probe joins a group and runs
one all-reduce of a tensor on the device (the card with nccl), printing
what the backend did. `spawn_group` starts the processes, each under a
timeout after which it is killed.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

GROUP_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_spec(path: str, **spec) -> str:
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    return path


def load_models(spec, device):
    """(cfg, generator params, {name: (CLIP cfg, params)}, ArcFace params)
    on `device`, from the spec's trees or seeds."""
    from ..convert import params_from_numpy
    from ..io import load_generator
    from ..models.arcface import init_backbone_params
    from ..models.clip import CLIP_CONFIGS, CLIPConfig, init_clip_params

    cfg, gp = load_generator(spec["network"], device=device)
    clips = {}
    for name, (fields, tree) in spec["clip"].items():
        ccfg = CLIPConfig(**fields) if fields else CLIP_CONFIGS[name]
        if isinstance(tree, int):
            tree = init_clip_params(torch.Generator().manual_seed(tree), ccfg,
                                    device="cpu")
        clips[name] = (ccfg, params_from_numpy(tree, device))
    arc = spec["arcface"]
    if isinstance(arc, int):
        arc = init_backbone_params(torch.Generator().manual_seed(arc),
                                   device="cpu")
    return cfg, gp, clips, params_from_numpy(arc, device)


def dp_step(spec, models, mesh):
    """find_direction over the spec's styles from its resume direction
    with `mesh` (None: the full batch in this process). → (direction
    numpy, info)."""
    from ..models.clip import FallbackTokenizer
    from ..train.find_direction import FindDirectionConfig, find_direction

    cfg, gp, clips, arc = models
    d, info = find_direction(gp, cfg, spec["styles"], clips, arc,
                             FindDirectionConfig(**spec["fdc"]),
                             tokenizer=FallbackTokenizer(), mesh=mesh,
                             resume_direction=spec["resume"])
    return d.cpu().numpy(), info


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far (B1-B5)."""
    from ..ops.kernels import modconv
    from ..ops.kernels.upfirdn2d import downsample2d_kernel, upsample2d_kernel

    return {"upsample2x": upsample2d_kernel.launches,
            "downsample2x": downsample2d_kernel.launches,
            "modconv_fwd": modconv.launch_fwd.launches,
            "modconv_bwd_data": modconv.launch_bwd_data.launches,
            "modconv_bwd_weight": modconv.launch_bwd_weight.launches}


def readings(direction, history, resume, ref) -> Dict[str, float]:
    """The run against a reference: the loss history's largest relative
    error, the direction's largest absolute one and the update's (direction
    − resume) relative L2."""
    h, rh = np.asarray(history, np.float64), np.asarray(ref["history"],
                                                        np.float64)
    d, rd = direction.astype(np.float64), ref["direction"].astype(np.float64)
    upd = rd - resume
    return {"history_rel": float(np.max(np.abs(h - rh) / np.abs(rh))),
            "direction_abs": float(np.abs(d - rd).max()),
            "update_rel_l2": float(np.linalg.norm(d - rd)
                                   / np.linalg.norm(upd))}


def run(spec, rank: int, world: int, port: int) -> Dict:
    from ..metrics.feature_stats import FeatureStats
    from ..parallel import stats as pstats
    from ..parallel.mesh import (DataMesh, initialize_distributed,
                                 process_count, process_index)

    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from ..device import disable_tf32
        disable_tf32(device)
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend=spec["backend"],
                           timeout_s=GROUP_TIMEOUT_S)
    assert process_count() == world and process_index() == rank
    out: Dict = {"rank": rank, "world": world, "backend": spec["backend"]}

    # (a) one DP step of find_direction over the group
    models = load_models(spec, device)
    mesh = DataMesh([device] * spec["shards"])
    torch.distributed.barrier()
    before = kernel_launches()
    t0 = time.perf_counter()
    direction, info = dp_step(spec, models, mesh)
    out["dp_step_s"] = time.perf_counter() - t0
    out["launches"] = {k: v - before[k] for k, v in kernel_launches().items()}
    out["history"] = info["history"]
    out["direction_sum"] = float(direction.astype(np.float64).sum())
    out["direction_norm"] = float(np.linalg.norm(
        direction.astype(np.float64)))
    out["refs"] = {}
    for name, ref in spec["refs"].items():
        r = readings(direction, info["history"], spec["resume"], ref)
        r["ok"] = bool(r["history_rel"] <= ref["history_rtol"]
                       and r[ref["direction_key"]] <= ref["direction_tol"])
        out["refs"][name] = r

    # (b) append_multihost with a real all-gather
    rng = np.random.RandomState(7)  # the same stream in every process
    all_rows = rng.randn(world, 5, 3).astype(np.float32)
    fs = FeatureStats(capture_all=True, capture_mean_cov=True)
    fs.append_multihost(all_rows[rank])
    want = all_rows.reshape(-1, 3)
    np.testing.assert_array_equal(fs.get_all(), want)
    mean, cov = fs.get_mean_cov()
    w64 = want.astype(np.float64)
    np.testing.assert_allclose(mean, w64.mean(0), rtol=1e-12)
    np.testing.assert_allclose(
        cov, w64.T @ w64 / len(w64) - np.outer(w64.mean(0), w64.mean(0)),
        rtol=1e-10, atol=1e-14)
    out["append_multihost"] = True

    # (c) Collector(cross_process=True) with a real all-reduce
    pstats._counters.clear()
    per_proc = rng.randn(world, 16).astype(np.float32)
    c = pstats.Collector(regex="xloss")
    for v in per_proc[rank]:
        pstats.report("xloss", v)
    c.update(cross_process=True)
    union = per_proc.reshape(-1).astype(np.float64)
    assert c.num("xloss") == union.size, c.num("xloss")
    np.testing.assert_allclose(c.mean("xloss"), union.mean(), rtol=1e-12)
    # each report's square is rounded to float32, as JAX's moments are
    np.testing.assert_allclose(c.std("xloss"), union.std(), rtol=1e-6)
    out["collector_cross_process"] = True
    torch.distributed.destroy_process_group()
    out["ok"] = all(r["ok"] for r in out["refs"].values())
    return out


def probe(backend: str, rank: int, world: int, port: int) -> int:
    """Join a group on `backend` and all-reduce one tensor on the card
    (nccl) or the host (gloo); print what happened."""
    dev = torch.device("cuda", 0) if backend == "nccl" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank)
    t = torch.full((4,), float(rank + 1), device=dev)
    torch.distributed.all_reduce(t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"rank {rank}: all_reduce over {backend} gave {t.tolist()}",
          flush=True)
    torch.distributed.destroy_process_group()
    return 0


def spawn_group(args_of_rank, world: int, timeout_s: float,
                env: Optional[Dict[str, str]] = None,
                program: Optional[List[str]] = None) -> List[Dict]:
    """Start `world` processes (`program`, by default `python -m
    stylemc_torch.bench.dp_ranks`, with args_of_rank(rank)), wait for each
    up to timeout_s in all, kill any still running. → [{"rc", "output",
    "timed_out"}] per rank."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(env if env is not None else os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    program = program or [sys.executable, "-m",
                          "stylemc_torch.bench.dp_ranks"]
    procs = [subprocess.Popen(
        [*program, *map(str, args_of_rank(r))], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    results = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                results.append({"rc": p.returncode, "output": out,
                                "timed_out": False})
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                results.append({"rc": p.returncode, "output": out,
                                "timed_out": True})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def main(argv: List[str]) -> int:
    if argv[0] == "--probe":
        return probe(argv[1], int(argv[2]), int(argv[3]), int(argv[4]))
    spec_path, rank, world, port, out_path = argv
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec.get("threads", torch.get_num_threads()))
    out = run(spec, int(rank), int(world), int(port))
    with open(out_path + ".tmp", "w") as f:
        json.dump(out, f, indent=1)
    os.replace(out_path + ".tmp", out_path)
    print(f"[rank {rank}] done, ok={out['ok']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
