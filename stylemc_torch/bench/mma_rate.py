"""The tensor cores' TF32 rate through `mma.sync` on one CUDA card: the
ceiling of the instruction that B3 and B5 are built on, against which their
TFLOP/s are read (3xTF32 spends three TF32 products on each product).

    python -m stylemc_torch.bench.mma_rate

`mma_sync_tf32_tflop_per_s()` builds `mma_rate.cu` (nvcc, at first use),
runs one 256-thread block per multiprocessor of 16 independent
accumulators a warp, and returns TFLOP/s from CUDA events. Without a CUDA
device it raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
from pathlib import Path

import torch

from stylemc_torch.device import resolve_device
from stylemc_torch.ops.kernels.build import build_library

from .timing import nvidia_smi_line

SOURCE = Path(__file__).resolve().parent / "mma_rate.cu"
FLOP_PER_MMA = 2 * 16 * 8 * 8
ACCUMULATORS = 16
THREADS = 256


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("mma_rate", [SOURCE])))
    lib.stylemc_mma_tf32_loop.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    lib.stylemc_mma_tf32_loop.restype = ctypes.c_int
    return lib


def mma_sync_tf32_tflop_per_s(device=None, iters: int = 4000) -> float:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the tensor cores' rate needs a CUDA device")
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(blocks * THREADS, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream

        def run(n):
            err = _library().stylemc_mma_tf32_loop(blocks, THREADS, n,
                                                    out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"mma_rate launch failed: CUDA error {err}")

        run(10)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run(iters)
        end.record()
        end.synchronize()
    mmas = blocks * THREADS // 32 * iters * ACCUMULATORS
    return mmas * FLOP_PER_MMA / start.elapsed_time(end) / 1e9


def main() -> int:
    print(json.dumps({"mma_sync_tf32_tflop_per_s": mma_sync_tf32_tflop_per_s(),
                      "card": nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
