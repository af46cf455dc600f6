"""Step-time meters and the JSONL metrics log: the port of
``pytorch_distributed_tpu/train/metrics.py``.

:class:`MetricsWriter` appends one JSON record per ``(step, metrics)``
event, ``{"step": 120, "wall_time": ..., "split": "train", "loss":
...}``, each value a float when it converts and its ``str`` otherwise:
line for line the JAX writer's records. :func:`read_metrics` loads them
back, skipping a line a kill cut short. :class:`TeeWriter` fans one
stream out to several writers (JSONL and TensorBoard); the trainer
writes from rank 0. :class:`ScalarMeter` keeps a window of step times
and samples/s, per card over the process's visible CUDA cards.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Dict, List

import torch

from pytorch_distributed_tpu_torch.utils.logging import get_logger
from pytorch_distributed_tpu_torch.utils.timing import percentile

logger = get_logger(__name__)


@dataclasses.dataclass
class MeterState:
    step_time: float  # seconds
    samples_per_sec: float


class ScalarMeter:
    """Running window over step timings; reports per-card throughput."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = collections.deque(maxlen=window)
        self._sps = collections.deque(maxlen=window)

    def update(self, s: MeterState) -> None:
        self._times.append(float(s.step_time))
        self._sps.append(float(s.samples_per_sec))

    @property
    def samples_per_sec(self) -> float:
        return sum(self._sps) / len(self._sps) if self._sps else 0.0

    @property
    def step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def samples_per_sec_per_chip(self) -> float:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return self.samples_per_sec / max(cards, 1)

    def summary(self) -> Dict[str, float]:
        return {
            "samples_per_sec": self.samples_per_sec,
            "samples_per_sec_per_chip": self.samples_per_sec_per_chip,
            "step_time_ms": self.step_time * 1e3,
            "step_time_p50_ms": percentile(self._times, 50) * 1e3,
            "step_time_p95_ms": percentile(self._times, 95) * 1e3,
        }


class MetricsWriter:
    """Append-only JSONL scalar log, line-buffered: one record a write."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float], *,
              split: str = "train") -> None:
        if self._f is None:   # closed at the end of a fit(): reopen
            self._f = open(self.path, "a", buffering=1)
        rec = {"step": int(step), "wall_time": time.time(), "split": split}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class TeeWriter:
    """One ``write(step, metrics, split=)`` stream to several writers."""

    def __init__(self, writers):
        self.writers = list(writers)

    def write(self, step, metrics, *, split: str = "train") -> None:
        for w in self.writers:
            w.write(step, metrics, split=split)

    def flush(self) -> None:
        for w in self.writers:
            if hasattr(w, "flush"):
                w.flush()

    def close(self) -> None:
        for w in self.writers:
            w.close()

    def __enter__(self) -> "TeeWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def read_metrics(path: str, *, strict: bool = False) -> List[dict]:
    """The records of a :class:`MetricsWriter` file. A torn last line (a
    kill mid-write) is skipped with a warning, or raises with
    ``strict=True``."""
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                if strict:
                    raise
                logger.warning("skipping torn metrics record at %s:%d (%d "
                               "bytes)", path, lineno, len(line))
    return out
