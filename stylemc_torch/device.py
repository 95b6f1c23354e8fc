"""Device selection for the port's entry points, and device→host copies
that overlap the device's work."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means `cuda`. A CUDA request with no CUDA device raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def disable_tf32(device: torch.device) -> None:
    """On a CUDA device, turn TF32 off for cuDNN convolutions and matmuls
    (process-wide torch flags): cuDNN runs fp32 convolutions in TF32 by
    default, which drifts from fp32. The fp32 entry points call it."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def host_later(a: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start copying `a` to the host (from a CUDA device into pinned
    memory, without waiting); → a function that waits for the copy and
    returns the host array."""
    if a.device.type != "cuda":
        host = a.cpu().numpy()
        return lambda: host
    buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    buf.copy_(a, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return buf.numpy()

    return wait
