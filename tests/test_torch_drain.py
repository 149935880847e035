"""The drain (``parallel/pipeline.py``): the port against JAX's classes on the CPU.

Mirrors ``tests/test_async_fetch.py``. ``RowWatermark``,
``fetch_chunked_async``, ``BlockDrain`` and ``LazyRowsView`` of both packages
get the same ``numpy.random.default_rng`` arrays (the port as torch CPU
tensors, JAX as CPU device arrays) and must give the same buffers bit for
bit, float16 wire chunks converted to float32 alike. On the CPU the port's
waiter thread copies each chunk itself, so the watermark, the gating of
views and the failure of every waiter run here as they do behind a card's
copy stream (``tests/test_torch_drain_card.py``). A chunk is held back by a
block whose conversion to an array waits on a ``threading.Event``.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.parallel import pipeline as jax_pipeline
from tiatoolbox_tpu_torch.parallel import pipeline

WAIT_S = 5.0  # every join and wait in this file is bounded


@pytest.fixture(scope="module")
def host() -> np.ndarray:
    return np.random.default_rng(3).normal(size=(97, 13, 5)).astype(np.float32)


def _jax(arr: np.ndarray):
    return jax.device_put(arr, jax.devices("cpu")[0])


class _HeldBack:
    """A block whose conversion to an array waits until ``release`` is set."""

    def __init__(self, arr: np.ndarray, release: threading.Event, fail: bool = False) -> None:
        self.arr, self.release, self.fail = arr, release, fail

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002 - numpy's protocol
        assert self.release.wait(WAIT_S)
        if self.fail:
            raise RuntimeError("the copy failed")
        return self.arr


def _run(target) -> tuple[threading.Thread, list]:
    """``target`` on a thread; the list gets its result or the exception it raised."""
    got: list = []

    def body() -> None:
        try:
            got.append(target())
        except Exception as exc:  # noqa: BLE001 - the test reads it
            got.append(exc)

    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    return thread, got


@pytest.mark.parametrize("n_chunks", [1, 4, 97, 200])
def test_async_fetch_equals_jax_and_the_sync_copy(host, n_chunks: int) -> None:
    buf, wm = pipeline.fetch_chunked_async(torch.from_numpy(host), n_chunks=n_chunks)
    want, jwm = jax_pipeline.fetch_chunked_async(_jax(host), n_chunks=n_chunks)
    wm.wait_all()
    jwm.wait_all()
    assert buf.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(buf, jax_pipeline.fetch_chunked(_jax(host)))
    assert wm.rows_ready == jwm.rows_ready == 97
    assert wm.drain_seconds is not None and wm.drain_seconds >= 0


def test_async_fetch_converts_float16_to_float32(host) -> None:
    buf, wm = pipeline.fetch_chunked_async(torch.from_numpy(host).half(), n_chunks=3, dtype=np.float32)
    want, jwm = jax_pipeline.fetch_chunked_async(_jax(host.astype(np.float16)), n_chunks=3, dtype=np.float32)
    wm.wait_all()
    jwm.wait_all()
    assert buf.dtype == np.float32
    np.testing.assert_array_equal(buf, want)
    np.testing.assert_array_equal(buf, host.astype(np.float16).astype(np.float32))


KEYS = {
    "rows": slice(10, 20),
    "rows and columns": (slice(10, 20), slice(2, 5)),
    "int": 96,
    "negative int": -1,
    "first row by a negative int": -97,
    "negative stop": slice(5, -1),
    "open slice": slice(None),
    "stepped": slice(3, 90, 7),
    "fancy rows": [3, 1, 2],
    "fancy array": np.array([96, 0]),
    "ellipsis": (Ellipsis, 0),
    "int row and column": (40, 7),
}


@pytest.mark.parametrize("name", list(KEYS))
def test_lazy_rows_view_indexes_as_jax(host, name: str) -> None:
    buf, wm = pipeline.fetch_chunked_async(torch.from_numpy(host), n_chunks=5)
    jbuf, jwm = jax_pipeline.fetch_chunked_async(_jax(host), n_chunks=5)
    view = pipeline.LazyRowsView(buf, wm, slice(1, 4))
    want = jax_pipeline.LazyRowsView(jbuf, jwm, slice(1, 4))
    key = KEYS[name]
    np.testing.assert_array_equal(view[key], want[key])
    np.testing.assert_array_equal(view[key], host[..., 1:4][key])


def test_lazy_rows_view_attributes_and_array_equal_jax(host) -> None:
    buf, wm = pipeline.fetch_chunked_async(torch.from_numpy(host))
    jbuf, jwm = jax_pipeline.fetch_chunked_async(_jax(host))
    for channels in (slice(1, 4), slice(0, 1), slice(4, None)):
        view = pipeline.LazyRowsView(buf, wm, channels)
        want = jax_pipeline.LazyRowsView(jbuf, jwm, channels)
        assert (view.shape, view.dtype, view.ndim, len(view)) == (want.shape, want.dtype, want.ndim, len(want))
        np.testing.assert_array_equal(np.asarray(view), np.asarray(want))
        assert np.asarray(view, dtype=np.float64).dtype == np.float64
    assert pipeline.LazyRowsView(buf, wm, slice(1, 4)).shape == (97, 13, 3)


def test_watermark_marks_the_contiguous_prefix_as_jax() -> None:
    """Out-of-order chunks: the prefix moves only when the gap fills."""
    slices = [slice(0, 10), slice(10, 20), slice(20, 30)]
    port, jax_wm = pipeline.RowWatermark(slices, 30), jax_pipeline.RowWatermark(slices, 30)
    seen = []
    for idx in (0, 2, 1):
        port._mark(idx)
        jax_wm._mark(idx)
        seen.append((port.rows_ready, jax_wm.rows_ready))
    assert seen == [(10, 10), (10, 10), (30, 30)]
    assert port.drain_seconds is not None


def test_watermark_gates_rows() -> None:
    """A waiter above the watermark blocks until the rows land; below it returns at once."""
    wm = pipeline.RowWatermark([slice(0, 10), slice(10, 20), slice(20, 30)], 30)
    wm._mark(0)
    wm.wait_rows(10)
    thread, got = _run(lambda: (wm.wait_rows(30), wm.rows_ready)[1])
    time.sleep(0.05)
    assert not got
    wm._mark(2)
    time.sleep(0.05)
    assert not got and wm.rows_ready == 10
    wm._mark(1)
    thread.join(WAIT_S)
    assert not thread.is_alive() and got == [30]


def test_held_back_chunk_gates_a_view(host) -> None:
    """Rows of chunks that landed read at once; a read past a held-back
    chunk waits until it lands."""
    release = threading.Event()

    def block_fn(y0: int, rows: int):
        block = host[y0 : y0 + rows]
        return _HeldBack(block, release) if y0 == 32 else torch.from_numpy(block)

    drain = pipeline.BlockDrain(block_fn, 97, host.shape, np.float32, block_h=32)
    drain.flush()
    view = pipeline.LazyRowsView(drain.buf, drain.watermark, slice(0, 5))
    np.testing.assert_array_equal(view[:32], host[:32])
    thread, got = _run(lambda: view[40])
    time.sleep(0.1)
    assert not got and drain.watermark.rows_ready == 32
    release.set()
    thread.join(WAIT_S)
    assert not thread.is_alive()
    np.testing.assert_array_equal(got[0], host[40])
    np.testing.assert_array_equal(np.asarray(view), host)


def test_errors_reach_every_waiter() -> None:
    """``_fail`` wakes every waiter with the error, as JAX's does; so does a
    copy that raises, through views on both sides of it."""
    for module in (pipeline, jax_pipeline):
        wm = module.RowWatermark([slice(0, 5)], 5)
        threads = [_run(lambda wm=wm: wm.wait_rows(5)) for _ in range(3)]
        wm._fail(RuntimeError("link died"))
        for thread, got in threads:
            thread.join(WAIT_S)
            assert not thread.is_alive()
            assert isinstance(got[0], RuntimeError) and "link died" in str(got[0])
    release = threading.Event()
    src = np.arange(40 * 3, dtype=np.float32).reshape(40, 3, 1)
    drain = pipeline.BlockDrain(
        lambda y0, rows: _HeldBack(src[y0 : y0 + rows], release, fail=y0 == 16),
        40, src.shape, np.float32, block_h=8,
    )
    drain.flush()
    view = pipeline.LazyRowsView(drain.buf, drain.watermark, slice(0, 1))
    waiters = [_run(lambda: view[30:40]), _run(lambda: np.asarray(view)), _run(drain.finish)]
    release.set()
    for thread, got in waiters:
        thread.join(WAIT_S)
        assert not thread.is_alive()
        assert isinstance(got[0], RuntimeError) and "the copy failed" in str(got[0])
    # as in JAX, a failed drain fails every later read, even of rows that landed
    with pytest.raises(RuntimeError, match="the copy failed"):
        view[:8]


@pytest.mark.parametrize("block_h", [32, 25, 97, 200])
def test_block_drain_equals_jax_under_the_same_advances(host, block_h: int) -> None:
    calls, jax_calls = [], []

    def port_fn(y0: int, rows: int) -> torch.Tensor:
        calls.append((y0, rows))
        return torch.from_numpy(host[y0 : y0 + rows])

    def jax_fn(y0: int, rows: int):
        jax_calls.append((y0, rows))
        return _jax(host[y0 : y0 + rows])

    port = pipeline.BlockDrain(port_fn, 97, host.shape, np.float32, block_h=block_h)
    want = jax_pipeline.BlockDrain(jax_fn, 97, host.shape, np.float32, block_h=block_h)
    for final_rows in (10, 40, 64, 96):
        port.advance(final_rows)
        want.advance(final_rows)
        assert calls == jax_calls
    ready = min(final_rows // block_h * block_h, 97)
    port.watermark.wait_rows(ready)
    want.watermark.wait_rows(ready)
    port.flush()
    want.flush()
    # the rows that had landed when flush was called
    assert port.bytes_hidden == want.bytes_hidden == ready * 13 * 5 * 4
    np.testing.assert_array_equal(port.finish(), want.finish())
    np.testing.assert_array_equal(port.buf, host)
    assert calls == jax_calls
    # at most two distinct block heights (body and tail), as JAX's
    assert len({rows for _, rows in calls}) <= 2


def test_block_drain_converts_to_its_dtype(host) -> None:
    half = torch.from_numpy(host).half()
    drain = pipeline.BlockDrain(lambda y0, rows: half[y0 : y0 + rows], 97, host.shape, np.float32, block_h=40)
    np.testing.assert_array_equal(drain.finish(), host.astype(np.float16).astype(np.float32))


def test_flush_then_view_gates(host) -> None:
    """``flush`` dispatches every block without waiting; a view waits for its rows."""
    release = threading.Event()
    src = host[:64, :4, :3]
    drain = pipeline.BlockDrain(
        lambda y0, rows: _HeldBack(src[y0 : y0 + rows], release) if y0 >= 16 else torch.from_numpy(src[:16]),
        64, (64, 4, 3), np.float32, block_h=16,
    )
    drain.flush()
    view = pipeline.LazyRowsView(drain.buf, drain.watermark, slice(0, 1))
    np.testing.assert_array_equal(view[0:16], src[:16, :, 0:1])
    thread, got = _run(lambda: np.asarray(view))
    time.sleep(0.05)
    assert not got
    release.set()
    thread.join(WAIT_S)
    assert not thread.is_alive()
    np.testing.assert_array_equal(got[0], src[..., 0:1])
