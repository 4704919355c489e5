"""Training metrics: a JSONL mirror, and tensorboard scalars where tensorboardX is.

Counterpart of ``hdenseformer_tpu/train/logging.py``, with the same tags:
every scalar is appended to ``<log_dir>/metrics.jsonl`` as {"tag",
"value", "step", "t"}, so a run can be read without tensorboard.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def _line(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step), "t": time.time()}) + "\n")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._line(tag, value, step)
        self._jsonl.flush()

    def add_scalars(self, tag: str, values: Dict[str, float], step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalars(tag, values, step)
        for k, v in values.items():
            self._line(f"{tag}/{k}", v, step)
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
