"""The launch floor on one CUDA card: the device time of an empty kernel
(one block of 32 threads), timed with `device_ms` as every kernel row of
`chip_smoke.py` is. Read beside B1's and B2's times, it says how much of
a small plane's time is the launch itself.

    python -m stylemc_torch.bench.launch_floor

`launch_floor_ms()` builds `launch_floor.cu` (nvcc, at first use) and
returns milliseconds per launch. Without a CUDA device it raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
from pathlib import Path

import torch

from stylemc_torch.device import resolve_device
from stylemc_torch.ops.kernels.build import build_library

from .timing import device_ms, nvidia_smi_line

SOURCE = Path(__file__).resolve().parent / "launch_floor.cu"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("launch_floor", [SOURCE])))
    lib.stylemc_launch_floor.argtypes = [ctypes.c_void_p]
    lib.stylemc_launch_floor.restype = ctypes.c_int
    return lib


def launch_floor_ms(device=None) -> float:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the launch floor needs a CUDA device")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream

        def launch():
            err = _library().stylemc_launch_floor(stream)
            if err != 0:
                raise RuntimeError(
                    f"launch_floor launch failed: CUDA error {err}")

        return device_ms(launch)


def main() -> int:
    print(json.dumps({"launch_floor_ms": launch_floor_ms(),
                      "card": nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
