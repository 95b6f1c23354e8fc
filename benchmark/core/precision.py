"""The configurations' float32 with TF32 off, and the control's TF32."""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch


def set_precision(config: Dict[str, Any]) -> None:
    """The configuration's float32, with TF32 off unless it says on."""
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuBLAS and cuDNN float32 work inside, as it was after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
