"""The dataset registry and the model-weight paths (counterpart of
`stylemc_tpu/data/configs.py`): dataset types map to source and target
roots and a transform set; a JSON file (STYLEMC_DATASETS_JSON, or a path)
overlays the roots."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional


@dataclasses.dataclass
class TransformsConfig:
    size: int = 256
    train_flip: bool = True


@dataclasses.dataclass
class DatasetSpec:
    train_source_root: str = ""
    train_target_root: str = ""
    test_source_root: str = ""
    test_target_root: str = ""
    transforms: TransformsConfig = dataclasses.field(
        default_factory=TransformsConfig)


DATASETS: Dict[str, DatasetSpec] = {
    "ffhq_encode": DatasetSpec(),
    "celeba_encode": DatasetSpec(),
    "cars_encode": DatasetSpec(transforms=TransformsConfig(size=256)),
    "church_encode": DatasetSpec(),
    "horse_encode": DatasetSpec(),
}


def load_registry(path: Optional[str] = None) -> Dict[str, DatasetSpec]:
    """DATASETS with the roots of a JSON registry file laid over them
    ({dataset_type: {train_source_root: ..., "transforms": {...}}})."""
    path = path or os.environ.get("STYLEMC_DATASETS_JSON")
    out = dict(DATASETS)
    if path and os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        for name, spec in data.items():
            base = dataclasses.asdict(out.get(name, DatasetSpec()))
            tf = base.pop("transforms")
            base.update({k: v for k, v in spec.items() if k != "transforms"})
            if "transforms" in spec:
                tf.update(spec["transforms"])
            out[name] = DatasetSpec(transforms=TransformsConfig(**tf), **base)
    return out


# model-weight paths, each from its environment variable
model_paths = {
    "stylegan_ffhq": os.environ.get("STYLEMC_STYLEGAN_FFHQ", ""),
    "ir_se50": os.environ.get("STYLEMC_ARCFACE", ""),
    "moco": os.environ.get("STYLEMC_MOCO", ""),
    "deeplab": os.environ.get("STYLEMC_DEEPLAB", ""),
    "mtcnn_dir": os.environ.get("STYLEMC_MTCNN_DIR", ""),
    "mobilenet": os.environ.get("STYLEMC_MOBILENET", ""),
    "clip_dir": os.environ.get("STYLEMC_CLIP_DIR", ""),
    "inception": os.environ.get("STYLEMC_INCEPTION", ""),
}
