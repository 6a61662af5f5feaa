"""Metrics / structured logging, PyTorch port's copy of ``flash_attention_dlrs_tpu/utils/metrics.py``.

A tiny JSONL metrics logger (one object per line) plus a rolling throughput
meter for training and serving loops.  Pure Python.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Optional


class MetricsLogger:
    """Append-only JSONL sink; no-ops cleanly when path is None."""

    def __init__(self, path: Optional[str] = None, *, flush_every: int = 1):
        self.path = path
        self._f = None
        self._n = 0
        self.flush_every = flush_every
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, step: int, **metrics) -> None:
        if self._f is None:
            return
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class ThroughputMeter:
    """Rolling tokens/s (or items/s) over the last `window` updates."""

    def __init__(self, window: int = 50):
        self.events = deque(maxlen=window)

    def update(self, count: int) -> None:
        self.events.append((time.perf_counter(), count))

    @property
    def rate(self) -> float:
        if len(self.events) < 2:
            return 0.0
        dt = self.events[-1][0] - self.events[0][0]
        total = sum(c for _, c in list(self.events)[1:])
        return total / dt if dt > 0 else 0.0
