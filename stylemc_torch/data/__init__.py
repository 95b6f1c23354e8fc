"""Image datasets (counterpart of `stylemc_tpu/data/`)."""
