"""Metrics logging and throughput meters (``diff_foley_tpu/utils/logging.py``).

JSONL is primary: one row per ``log`` call with the prefixed metrics,
``step`` and the wall-clock ``time``. TensorBoard is optional, through
``tensorboardX`` where it imports. A logger without a directory (the
trainers' ranks other than 0) writes nothing.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str], name: str = "results",
                 use_tensorboard: bool = False):
        self.jsonl_path = None
        self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{name}.jsonl")
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass

    def log(self, step: int, metrics: Dict, prefix: str = "") -> None:
        if self.jsonl_path is None:
            return
        payload = {f"{prefix}{k}": _to_py(v) for k, v in metrics.items()}
        payload["step"] = int(step)
        payload["time"] = time.time()
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(payload) + "\n")
        if self._tb is not None:
            for k, v in payload.items():
                if isinstance(v, (int, float)) and k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class Meter:
    """Running average of a step or data time, or a throughput."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0
        self.last = 0.0

    def update(self, value: float, n: int = 1):
        self.last = value
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Stopwatch:
    def __init__(self):
        self.t = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt
