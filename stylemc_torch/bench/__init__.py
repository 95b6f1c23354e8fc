"""Measurements of the port on a CUDA card (`python -m
stylemc_torch.bench.<name>`); each raises without one.
`tf_pickle.write_tf_pickle` writes a legacy TensorFlow pickle from given
params and needs no card."""
