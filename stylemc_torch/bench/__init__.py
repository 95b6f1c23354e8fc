"""Measurements of the port on a CUDA card (`python -m
stylemc_torch.bench.<name>`); each raises without one."""
