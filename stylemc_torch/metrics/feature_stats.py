"""Feature accumulation for GAN metrics (counterpart of
`stylemc_tpu/metrics/feature_stats.py`): raw features and/or a running
float64 mean and covariance, capped at `max_items`. Features may arrive as
numpy arrays or as torch tensors on any device; they are kept on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class FeatureStats:
    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
        else:
            self.num_features = num_features
            self.all_features = []
            self.raw_mean = np.zeros([num_features], np.float64)
            self.raw_cov = np.zeros([num_features, num_features], np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            if self.num_items + x.shape[0] > self.max_items:
                x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def append_multihost(self, x):
        """Append the features of every process of the torch.distributed
        group, process-major (each passes the same number of rows); under
        one process, `append`."""
        from ..parallel.mesh import all_gather_rows

        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        self.append(all_gather_rows(np.asarray(x, np.float32)))

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items
        cov = cov - np.outer(mean, mean)
        return mean, cov
