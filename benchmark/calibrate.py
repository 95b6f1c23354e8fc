"""Readings that a cell's correctness limits are set from, in one process.

    python3 benchmark/calibrate.py --workload ffhq256.edit_open \
        --seeds 11-22 --control-seeds 11-13 --seconds 5

For each seed of --seeds: the cell's set-up (weights from that seed), a
window of --seconds at the cell's own load, the program's state freed,
and the numbers the run compares, as the run computes them (a JSON line
"program"). For each seed of --control-seeds also the control: the plain
reference at TF32 put in the program's place on the same inputs (a line
"control"); for each seed of --fault-seeds, where the cell's driver
lists FAULTS, the float32 reference with each fault planted (a line
"fault"). The limits in benchmark/limits/<cell>.json lie between the
program's largest reading and the smallest of the control's and the
faults' that fail them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core.cell import load_cell
    from benchmark.core.precision import set_precision
    from benchmark.core.runner import Ctx
    from benchmark.core.timing import card_state

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    driver = cell.driver
    set_precision(cell.config)
    program = set(seeds(args.seeds))
    control = set(seeds(args.control_seeds)) if args.control_seeds else set()
    faults = set(seeds(args.fault_seeds)) if args.fault_seeds else set()
    print(json.dumps({"card": card_state()}), flush=True)
    for seed in sorted(program | control | faults):
        ctx = Ctx(cell, seed, args.seconds, False, torch.device("cuda"))
        state = driver.setup(ctx)
        record = driver.window(ctx, state)
        outputs = record.pop("outputs")
        inputs = driver.release(ctx, state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "attempted": record["attempted"],
                "failed": record["failed"]}
        if seed in program:
            print(json.dumps({"program": driver.check(ctx, inputs, outputs),
                              **line}), flush=True)
        if seed in control:
            ctrl = driver.control(ctx, inputs, outputs)
            print(json.dumps({"control": driver.check(ctx, inputs, ctrl),
                              **line}), flush=True)
        for fault in getattr(driver, "FAULTS", ()) if seed in faults else ():
            planted = driver.control(ctx, inputs, outputs, fault=fault)
            print(json.dumps({"fault": fault, "readings": driver.check(
                ctx, inputs, planted), **line}), flush=True)
        del inputs, outputs
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"seconds": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
