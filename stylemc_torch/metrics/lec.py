"""Latent Editing Consistency (counterpart of `stylemc_tpu/metrics/lec.py`):
encode → edit → decode → re-encode → inverse edit; the score is the mean L2
between the original and the round-tripped codes, over the batches whose
distance lies in the [1 %, 99 %] quantiles."""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..convert import as_float32


def _filter_outliers(arr: np.ndarray) -> np.ndarray:
    lo = np.percentile(arr, 1, method="lower")
    hi = np.percentile(arr, 99, method="higher")
    return np.extract(np.logical_and(lo <= arr, arr <= hi), arr)


def calculate_lec(psp, data_iter: Iterable, edit_function: Callable,
                  inverse_edit_function: Callable,
                  n_batches: int = 16) -> float:
    """psp: models.e4e.psp.PSP (the codes run on its device); data_iter
    yields (x, _) batches or bare x, [N, 3, 256, 256] in [-1, 1] (numpy or
    tensors)."""
    dev = psp.decoder_params["synthesis"]["b4"]["const"].device

    def roundtrip(x):
        codes = psp.encode(x)
        image = psp.decode(edit_function(codes), resize=True,
                           noise_mode="const")
        inv = inverse_edit_function(psp.encode(image))
        return (codes - inv).square().sum(dim=(1, 2)).sqrt().mean()

    distances = []
    with torch.no_grad():
        for i, batch in enumerate(data_iter):
            if i >= n_batches:
                break
            x = batch[0] if isinstance(batch, tuple) else batch
            distances.append(float(roundtrip(as_float32(x, dev))))
    return float(_filter_outliers(np.asarray(distances)).mean())
