"""Find the highest request rate an open-loop cell sustains, once, on the
card: one set-up, then a window at each rate of --rates.

    python3 benchmark/sweep_rate.py --workload ffhq256.edit_open \
        --rates 8,10,12,14,16 --seconds 20 --seed 7

A rate is sustained when every request answers and the backlog does not
grow: the median latency of the window's last quarter of requests stays
within 1.5 times that of its first quarter. One JSON line per rate (p50,
p95, images per second answered, the two quarters' medians, sustained),
then the highest sustained rate and 4/5 of it, the rate that a cell's
traffic file takes.
"""

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core.cell import load_cell
    from benchmark.core.precision import set_precision
    from benchmark.core.runner import Ctx

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    driver = cell.driver
    set_precision(cell.config)
    state = driver.setup(Ctx(cell, args.seed, args.seconds, False,
                             torch.device("cuda")))
    best = None
    for rate in (float(r) for r in args.rates.split(",")):
        swept = copy.deepcopy(cell)
        swept.traffic["rate_per_s"] = rate
        ctx = Ctx(swept, args.seed, args.seconds, False, torch.device("cuda"))
        state["requests"] = driver.schedule(swept.traffic, args.seconds,
                                            args.seed)
        state["check"] = set()
        rec = driver.window(ctx, state)
        lat = rec["latencies_ms"]
        quarter = max(1, len(lat) // 4)
        first, last = np.median(lat[:quarter]), np.median(lat[-quarter:])
        ok = rec["failed"] == 0 and last <= 1.5 * first
        print(json.dumps({"rate_per_s": rate, "requests": len(lat),
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "images_per_s": rec["images"] / rec["window_s"],
                          "rows_per_call": rec["images"]
                          / max(1, rec["batched_calls"]),
                          "first_quarter_ms": float(first),
                          "last_quarter_ms": float(last),
                          "sustained": bool(ok)}), flush=True)
        if ok:
            best = rate
    driver.release(None, state)
    print(json.dumps({"highest_sustained_per_s": best,
                      "cell_rate_per_s": None if best is None
                      else 0.8 * best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
