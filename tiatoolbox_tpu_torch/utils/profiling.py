"""Tracing and profiling (counterpart of ``tiatoolbox_tpu/utils/profiling.py``).

- ``StageTimer`` (:23): seconds and item counts per named stage; the
  engines fill it from the main thread and from band reader threads.
- ``trace`` (:74): a ``torch.profiler`` window over the host and the CUDA
  devices, written as a Chrome trace (Perfetto, ``chrome://tracing``).
- ``log_memory`` (:86): host RSS and each CUDA device's allocated bytes.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

from tiatoolbox_tpu_torch import logger

TRACE_FILE = "trace.json"


class StageTimer:
    """Accumulate wall time and item counts per pipeline stage (thread-safe).

    Example:
        >>> timer = StageTimer()
        >>> with timer.stage("read", items=32):
        ...     ...
        >>> timer.report()
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

    def report(self) -> None:
        """Log one line a stage: its seconds and, with items, its rate."""
        for name, entry in self.summary().items():
            rate = f" ({entry['items_per_sec']}/s)" if "items_per_sec" in entry else ""
            logger.info("stage %-12s %6.2fs%s", name, entry["seconds"], rate)


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """Profile the ``with`` block on the host and, where present, the CUDA
    devices; on exit write the Chrome trace ``log_dir/trace.json``.

    Yields ``log_dir`` (by default ``tiatpu_torch_trace`` in the temporary
    directory). The trace's ``"cat": "kernel"`` events are the device's
    kernels, each with its device time in ``"dur"`` (microseconds).
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = str(log_dir or Path(tempfile.gettempdir()) / "tiatpu_torch_trace")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))
    logger.info("Device trace written to %s", log_dir)


def _host_rss_bytes() -> int:
    """Resident set size of this process, from ``/proc/self/statm``."""
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE")


def log_memory(tag: str = "") -> dict:
    """Snapshot host RSS and each CUDA device's allocated bytes, in MB:
    ``{"host_rss_mb": ..., "cuda:0": {"bytes_in_use_mb", "peak_bytes_mb"}}``."""
    stats: dict = {}
    with contextlib.suppress(OSError):
        stats["host_rss_mb"] = _host_rss_bytes() / (1 << 20)
    if torch.cuda.is_available():
        for index in range(torch.cuda.device_count()):
            mem = torch.cuda.memory_stats(index)
            stats[f"cuda:{index}"] = {
                "bytes_in_use_mb": mem.get("allocated_bytes.all.current", 0) / (1 << 20),
                "peak_bytes_mb": mem.get("allocated_bytes.all.peak", 0) / (1 << 20),
            }
    if tag:
        logger.info("memory[%s]: %s", tag, stats)
    return stats
