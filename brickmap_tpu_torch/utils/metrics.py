"""Metrics and frame timing (the port's copy of ``MetricsLogger``,
``FrameTimer`` and ``timed`` from ``brickmap_tpu/utils/metrics.py``): a
JSONL metrics writer, the same avg/min/max/fps statistics the reference's
``PerformanceMeasure`` appends to performance.txt
(``performance_measure.cpp:82-101``), and a scoped timer.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["MetricsLogger", "FrameTimer", "timed"]


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


@contextmanager
def timed(label: str, sink: dict | None = None):
    """Time the block: add its seconds to ``sink[label]``, or print its ms
    when no ``sink`` is given."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
    else:
        print(f"{label}: {dt * 1000:.1f} ms")
