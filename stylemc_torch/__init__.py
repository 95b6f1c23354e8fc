"""stylemc_torch: the StyleMC editing stack in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `stylemc_tpu` that mirrors its module names and public layouts
(NCHW images, OIHW weights, packed [N, 26, 512] S-space styles, the params
tree of `models/stylegan2/generator.py`) so both packages read and write the
same files. It imports torch, numpy and the standard library (the CLIs
also click and Pillow, the face crop OpenCV and the FFHQ alignment SciPy,
as the JAX package's do), never JAX.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA device and no explicit CPU request they raise (see `device.py`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
