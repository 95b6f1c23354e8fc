"""GAN evaluation: FID, KID, Precision & Recall and Inception Score on
Inception v3 features, Perceptual Path Length on LPIPS-VGG, and Latent
Editing Consistency (counterpart of `stylemc_tpu/metrics/`)."""

from .metric_main import (
    MetricOptions, calc_metric, is_valid_metric, list_valid_metrics,
    register_metric,
)
from .feature_stats import FeatureStats
from .scores import (
    fid_from_stats, kid_from_features, inception_score_from_probs,
    precision_recall_from_features,
)
from .ppl import compute_ppl, slerp

__all__ = [
    "MetricOptions", "calc_metric", "is_valid_metric", "list_valid_metrics",
    "register_metric", "FeatureStats",
    "fid_from_stats", "kid_from_features", "inception_score_from_probs",
    "precision_recall_from_features", "compute_ppl", "slerp",
]
