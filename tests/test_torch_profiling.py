"""``utils/profiling.py``: the port's ``StageTimer``, ``trace`` and ``log_memory`` against JAX's, on the CPU.

- ``StageTimer.summary`` and ``StageTimer.report`` give JAX's entries and
  log lines (through ``caplog``, attached to each package's logger: both
  stop propagation) for the same stages, added from several threads.
- ``trace`` writes a Chrome trace that ``json`` reads, holding the ops run
  inside the window, and yields its directory as JAX's does.
- ``log_memory`` gives the host RSS (from ``/proc/self/statm``) within
  16 MB of psutil's, which JAX reads, and on the CPU no device entry, as
  JAX's on its CPU devices.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

import numpy as np
import psutil
import pytest
import torch

from tiatoolbox_tpu import logger as jax_logger
from tiatoolbox_tpu.utils import profiling as jax_profiling
from tiatoolbox_tpu_torch import logger as port_logger
from tiatoolbox_tpu_torch.utils import profiling

STAGES = [("read", 0.4321, 64), ("wire", 0.0123, 0), ("infer", 1.25, 64), ("read", 0.5, 32), ("fetch", 3e-5, 7)]


def both_timers(stages=STAGES) -> tuple:
    """The port's and JAX's timers, each given ``stages`` from four threads."""
    port, jax_timer = profiling.StageTimer(), jax_profiling.StageTimer()

    def feed(timer) -> None:
        for name, seconds, items in stages:
            timer.add(name, seconds, items)

    for timer in (port, jax_timer):
        threads = [threading.Thread(target=feed, args=(timer,)) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return port, jax_timer


def test_summary_matches_jax() -> None:
    port, jax_timer = both_timers()
    assert port.summary() == jax_timer.summary()
    assert port.summary()["read"] == {"seconds": round(4 * 0.9321, 4), "items": 384,
                                      "items_per_sec": round(384 / (4 * 0.9321), 2)}
    assert "items" not in port.summary()["wire"]


def test_stage_context_adds_seconds_and_items() -> None:
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("decode", items=5):
            pass
    entry = timer.summary()["decode"]
    assert entry["items"] == 15 and 0 <= entry["seconds"] < 1


@pytest.mark.parametrize("stages", [STAGES, [], [("idle", 0.0, 0)]], ids=["stages", "empty", "zero"])
def test_report_logs_jax_lines(caplog, stages) -> None:
    port, jax_timer = both_timers(stages)
    lines = {}
    for name, lgr, timer in (("port", port_logger, port), ("jax", jax_logger, jax_timer)):
        caplog.clear()
        lgr.addHandler(caplog.handler)
        try:
            with caplog.at_level(logging.INFO, logger=lgr.name):
                timer.report()
        finally:
            lgr.removeHandler(caplog.handler)
        lines[name] = [(r.levelno, r.getMessage()) for r in caplog.records]
    assert lines["port"] == lines["jax"]
    assert len(lines["port"]) == len({name for name, *_ in stages})
    if stages is STAGES:
        rate = round(384 / round(4 * 0.9321, 4), 2)
        assert lines["port"][0] == (logging.INFO, f"stage read         {4 * 0.9321:6.2f}s ({rate}/s)")


def test_trace_writes_a_readable_chrome_trace(tmp_path: Path) -> None:
    log_dir = tmp_path / "window"
    x = torch.from_numpy(np.random.default_rng(0).random((64, 64), np.float32))
    with profiling.trace(log_dir) as where:
        assert where == str(log_dir)
        y = torch.mm(x, x).relu_()
    events = json.loads((log_dir / profiling.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names) and any("relu" in n for n in names)
    assert float(y.sum()) > 0


def test_trace_defaults_under_the_temporary_directory(tmp_path: Path, monkeypatch) -> None:
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiling.trace() as where:
        torch.ones(8).add_(1)
    assert Path(where) == tmp_path / "tiatpu_torch_trace"
    assert (Path(where) / profiling.TRACE_FILE).is_file()


def test_log_memory_host_rss_and_devices(caplog) -> None:
    stats = profiling.log_memory()
    rss = psutil.Process().memory_info().rss / (1 << 20)
    assert abs(stats["host_rss_mb"] - rss) < 16
    jax_stats = jax_profiling.log_memory()
    assert set(jax_stats) == {"host_rss_mb"}
    if torch.cuda.is_available():
        assert set(stats) == {"host_rss_mb", *(f"cuda:{i}" for i in range(torch.cuda.device_count()))}
        assert set(stats["cuda:0"]) == {"bytes_in_use_mb", "peak_bytes_mb"}
    else:
        assert set(stats) == set(jax_stats)
    port_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=port_logger.name):
            tagged = profiling.log_memory("after load")
    finally:
        port_logger.removeHandler(caplog.handler)
    assert set(tagged) == set(stats)
    assert caplog.records[-1].getMessage().startswith("memory[after load]: {'host_rss_mb': ")
