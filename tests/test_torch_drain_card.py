"""The drain on the card: stream order, the caching allocator and the interpreter lock.

``fetch_chunked_async`` and ``BlockDrain`` queue each chunk's copy on the
device's copy stream after an event recorded on the producing stream, tell
the allocator that the copy stream reads the chunk, and complete the chunks
on a waiter thread. These tests import the port only (the card machine has
no flax) and check inside each test whether there is a card; run them there
with ``python -m pytest -m cuda tests/test_torch_drain_card.py``.

``torch.cuda._sleep(cycles)`` holds the compute stream (about half a
second at 1e9 cycles on an H100), so whatever is queued behind it is still
pending when the drain is dispatched.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.parallel import pipeline

SLEEP_CYCLES = 1_000_000_000


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's instance phase drains through the same code")
    device = torch.device("cuda")
    # the copy stream's and a kernel module's first use wait for the card
    # (scripts/probe_drain_syncs.py): the engine prepares both before its loop
    pipeline.prepare_device(device)
    return device


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.uint8])
def test_fetch_waits_for_the_producing_stream(card, n_chunks: int, dtype) -> None:
    """The copy reads what the compute stream wrote after a long sleep, not what was there before."""
    x = torch.zeros((2048, 1000, 2), dtype=dtype, device=card)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(3)
    x[-1].fill_(5)
    out_dtype = np.float32 if dtype == torch.float16 else None
    buf, wm = pipeline.fetch_chunked_async(x, n_chunks=n_chunks, dtype=out_dtype)
    assert wm.rows_ready == 0  # dispatched without a wait
    wm.wait_all()
    assert buf.dtype == (np.float32 if dtype == torch.float16 else x.cpu().numpy().dtype)
    assert (buf[:-1] == 3).all() and (buf[-1] == 5).all()
    if dtype != torch.float16:  # the chunks land straight in the pinned buffer
        assert torch.from_numpy(buf).is_pinned()


@pytest.mark.cuda
def test_dropped_tensor_is_not_reused_before_its_copy(card) -> None:
    """The device tensor's last reference goes right after dispatch; a new
    tensor of its size is made and overwritten on the compute stream. The
    allocator must not hand it the block the copy stream still reads."""
    x = torch.empty((4096, 4096), device=card)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(7.0)
    old_ptr = x.data_ptr()
    buf, wm = pipeline.fetch_chunked_async(x, n_chunks=2)
    del x
    y = torch.empty((4096, 4096), device=card)
    y.fill_(-1.0)
    assert y.data_ptr() != old_ptr
    wm.wait_all()
    assert (buf == 7.0).all()
    torch.cuda.synchronize()
    assert (y == -1.0).all()


@pytest.mark.cuda
def test_waiting_for_a_copy_lets_go_of_the_interpreter_lock(card) -> None:
    """While the waiter thread waits for a copy behind a long sleep, this
    thread keeps running Python."""
    x = torch.zeros((1024, 1024), device=card)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(1.0)
    t0 = time.perf_counter()
    buf, wm = pipeline.fetch_chunked_async(x)
    spins = 0
    while wm.rows_ready < 1024 and time.perf_counter() - t0 < 30:
        spins += 1
    seconds = time.perf_counter() - t0
    wm.wait_all()
    assert seconds > 0.05, f"the sleep held the copy for only {seconds} s"
    assert spins > 10_000, f"{spins} loop turns in {seconds} s"
    assert (buf == 1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("block_h", [300, 2048])
def test_block_drain_on_the_card(card, block_h: int) -> None:
    """Blocks made on the card land in order behind a sleep; a float16 block
    converts into the float32 buffer; a view waits for its rows."""
    gen = torch.Generator(device=card).manual_seed(0)
    src = torch.rand((2048, 333, 3), generator=gen, device=card)
    want = src.half().float().cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    scaled = src * 1.0  # queued behind the sleep

    drain = pipeline.BlockDrain(
        lambda y0, rows: scaled[y0 : y0 + rows].half(), 2048, want.shape, np.float32, block_h=block_h
    )
    drain.advance(1000)
    drain.flush()
    view = pipeline.LazyRowsView(drain.buf, drain.watermark, slice(1, 3))
    np.testing.assert_array_equal(view[:300], want[:300, :, 1:3])
    np.testing.assert_array_equal(np.asarray(view), want[..., 1:3])
    np.testing.assert_array_equal(drain.finish(), want)
