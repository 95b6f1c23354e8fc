"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each kernel's source lives in `csrc/`, is compiled by nvcc at first use into
`build/stylemc_torch_kernels/<md5>/` (`build.py`) and is loaded with ctypes.
Beside each wrapper sits the kernel's plain torch version, which the wrapper
runs for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises. Nothing here imports or builds at module import time.
"""
