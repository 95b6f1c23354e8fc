"""Experiment logging to a local file: the run config and scalars with their
step go to {outdir}/wandb_log.jsonl (the JSONL backend of
`stylemc_tpu/utils/logging.py`, the same records). The port never starts
wandb, whose init reaches for the network, even where the package is
installed."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(self, project: str, config: Optional[Dict] = None,
                 outdir: str = "."):
        os.makedirs(outdir, exist_ok=True)
        self._file = open(os.path.join(outdir, "wandb_log.jsonl"), "a")
        self._write({"event": "init", "project": project,
                     "time": time.time(), "config": config or {}})

    def _write(self, record: Dict[str, Any]) -> None:
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log(self, values: Dict[str, Any], step: Optional[int] = None):
        scalars = {}
        for k, v in values.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                scalars[k] = str(v)
        self._write({"step": step, **scalars})

    def finish(self):
        self._file.close()
