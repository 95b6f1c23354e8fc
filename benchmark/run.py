"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload ffhq256.find_direction \
        --seed 1234 --seconds 30 --trace 0

Set-up (weights made on the card from the seed, the port's kernels built
or found under build/, the cell's shapes warmed up), then the measured
window of `--seconds`, then the comparison with the plain reference. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last
"compared": each number compared with its limit, which also close
standard error. Without a CUDA device, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_environment() -> None:
    """Caches at fixed paths inside the checkout; libraries kept off
    JAX."""
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core.cell import load_cell
    from benchmark.core.runner import ForbiddenModules, run_cell
    from benchmark.core.timing import card_state

    # one process with few threads: the program's host work is Python
    # launching kernels, and idle OpenMP workers only contend with it
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"card {card_state()}", file=sys.stderr, flush=True)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), T0)
    except ForbiddenModules as err:
        print(str(err), file=sys.stderr)
        return 4
    print(f"card {card_state()}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread and child has ended; skip the interpreter's teardown,
    # where the profiler's library has crashed after a finished run
    os._exit(code)
