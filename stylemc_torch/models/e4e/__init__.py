"""e4e / pSp real-image inversion: encoders, the pSp wrapper and the latent
editing baselines (counterpart of `stylemc_tpu/models/e4e/`)."""
