"""Metrics and frame timing (the port's copy of ``MetricsLogger`` and
``FrameTimer`` from ``brickmap_tpu/utils/metrics.py``): a JSONL metrics
writer, and the same avg/min/max/fps statistics the reference's
``PerformanceMeasure`` appends to performance.txt
(``performance_measure.cpp:82-101``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

__all__ = ["MetricsLogger", "FrameTimer"]


class MetricsLogger:
    """Append-mode JSONL metrics, one record per ``log`` call."""

    def __init__(self, path: str | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, step: int, **values) -> None:
        rec = {"step": step, "ts": time.time(), **values}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            print(json.dumps(rec))

    def close(self) -> None:
        if self._fh:
            self._fh.close()


@dataclass
class FrameTimer:
    """avg/min/max frame ms + fps over a window (performance_measure.cpp:82-99)."""

    times_ms: list = field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.times_ms.append(seconds * 1000.0)

    def stats(self) -> dict:
        if not self.times_ms:
            return {"frames": 0}
        avg = sum(self.times_ms) / len(self.times_ms)
        return {
            "frames": len(self.times_ms),
            "avg_ms": avg,
            "min_ms": min(self.times_ms),
            "max_ms": max(self.times_ms),
            "fps": 1000.0 / avg if avg > 0 else 0.0,
        }

    def reset(self) -> None:
        self.times_ms.clear()
