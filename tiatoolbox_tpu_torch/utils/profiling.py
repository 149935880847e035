"""Per-stage wall time (counterpart of ``tiatoolbox_tpu/utils/profiling.py:23``).

``StageTimer`` accumulates seconds and item counts per named stage; the
segmentor's device-canvas paths fill it from the main thread and from band
reader threads. ``trace`` and ``log_memory`` come with the port's benchmark.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulate wall time and item counts per pipeline stage (thread-safe).

    Example:
        >>> timer = StageTimer()
        >>> with timer.stage("read", items=32):
        ...     ...
        >>> timer.summary()
    """

    def __init__(self) -> None:
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        """Time the body of the ``with`` block as one run of stage ``name``."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start, items)

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        """Add ``seconds`` and ``items`` to stage ``name``."""
        with self._lock:
            self.times[name] += seconds
            self.counts[name] += items

    def summary(self) -> dict[str, dict]:
        """``{stage: {"seconds", and with items "items", "items_per_sec"}}``."""
        out = {}
        for name, seconds in self.times.items():
            entry = {"seconds": round(seconds, 4)}
            if self.counts[name]:
                entry["items"] = self.counts[name]
                entry["items_per_sec"] = round(self.counts[name] / max(seconds, 1e-9), 2)
            out[name] = entry
        return out
