"""The benchmark of stylemc_torch on an NVIDIA H100 (see run.py)."""
