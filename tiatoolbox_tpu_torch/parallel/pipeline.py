"""Host batch loading (counterpart of ``tiatoolbox_tpu/parallel/pipeline.py``).

``BatchLoader`` (:94-236) iterates a dataset as fixed-size batches with
reader threads and background prefetch, writing each item straight into
preallocated batch slots. Before a batch's reads it calls the dataset's
``prefetch`` where there is one (:131-134): one threaded native decode of
every JPEG tile the batch touches. A ``StageTimer`` set as ``timer``
accumulates "decode" (a batch's prefetch and reads, and any wait for a
free pinned slot, which "slot_wait" counts), "prefetch" (the tile decode
alone) and "wire" (``iter_staged``'s stage function). For a CUDA consumer, ``iter_staged`` writes the
images into a ring of pinned host slots; the stage function copies a slot
to the device asynchronously, and the slot is reused once the device has
passed an event recorded after that copy. With a pack function (the
yuv420 wire, ``ModelABC.pack_wire``) the reader thread packs each batch
into a buffer of its own under a "pack" stage, and the RGB slot goes back
to the ring as soon as the pack has read it: the device never reads it.

The other direction is the drain (:281-496), which lets host
post-processing start on rows that have landed while the rest of a device
map is still on its way. ``fetch_chunked_async`` and ``BlockDrain`` queue
row chunks on one copy stream per device (``copy_stream``), each after an
event recorded on the stream that produced it, into a host buffer that is
pinned wherever CUDA is available; a daemon thread waits for each chunk's
event and marks it on a ``RowWatermark``, and a ``LazyRowsView`` reads a
channel slice of the buffer, waiting for the rows it is asked for. For a
CPU tensor the thread copies the chunk itself, so the same watermark logic
runs in the CPU tests. Every device-to-host copy of a map goes this way,
the synchronous ones too (they wait on the watermark). ``prepare_device``
does before a loop what a drain's first use would otherwise do behind the
loop's queued work.
"""

from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from tiatoolbox_tpu_torch import _build


class _PinnedSlot:
    """One pinned host buffer and the event after which it may be rewritten."""

    def __init__(self) -> None:
        self.tensor: torch.Tensor | None = None
        self.event: torch.cuda.Event | None = None

    def buffer(self, shape: tuple, dtype: np.dtype) -> np.ndarray:
        """A numpy view of this slot, (re)allocated for ``shape``/``dtype``."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        want = torch.from_numpy(np.empty(0, dtype)).dtype
        if self.tensor is None or tuple(self.tensor.shape) != shape or self.tensor.dtype != want:
            self.tensor = torch.empty(shape, dtype=want, pin_memory=True)
        return self.tensor.numpy()


class _SlotRing:
    """A fixed set of pinned slots handed out and returned through a queue."""

    def __init__(self, n_slots: int) -> None:
        self._free: queue.Queue = queue.Queue()
        for _ in range(n_slots):
            self._free.put(_PinnedSlot())

    def acquire(self, stop: threading.Event) -> _PinnedSlot | None:
        """A free slot, or None once ``stop`` is set."""
        while not stop.is_set():
            try:
                return self._free.get(timeout=0.05)
            except queue.Empty:
                continue
        return None

    def give_back(self, slot: _PinnedSlot) -> None:
        """Return ``slot``, which no device work reads."""
        self._free.put(slot)

    def release(self, slot: _PinnedSlot, device: torch.device) -> None:
        """Return ``slot``; it is rewritten only after work queued on ``device`` so far."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        slot.event = event
        self._free.put(slot)


class _Stopped(Exception):
    """The consumer stopped before a slot was free."""


class BatchLoader:
    """Iterate a dataset as fixed-size batches with background prefetch.

    Args:
        dataset: Indexable returning dicts with "image" (+ extras).
        batch_size: Fixed batch size (the tail is padded to this size).
        num_workers: Reader threads; 0 = synchronous in-loop reads.
        prefetch: Number of batches buffered ahead.
        indices: Dataset indices to visit (all by default).

    Yields:
        dict with "image" uint8 ``[B, H, W, C]``, "n_valid", "indices", plus
        any other per-item arrays stacked on axis 0 (padded like images).
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        num_workers: int = 8,
        prefetch: int = 2,
        indices: np.ndarray | None = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self.prefetch = max(int(prefetch), 1)
        self.timer = None
        self.indices = (
            np.arange(len(dataset)) if indices is None else np.asarray(indices)
        )

    def __len__(self) -> int:
        return -(-len(self.indices) // self.batch_size)

    def _load_batch(
        self,
        batch_indices: np.ndarray,
        pool,
        slots: _SlotRing | None = None,
        stop: threading.Event | None = None,
        pack_fn: Callable | None = None,
    ) -> dict:
        with self._stage("decode", len(batch_indices)):
            batch = self._read_batch(batch_indices, pool, slots, stop)
        if pack_fn is not None:
            with self._stage("pack", batch["image"].nbytes):
                batch["image"] = pack_fn(batch["image"])
            slot = batch.pop("_slot", None)
            if slot is not None:
                slots.give_back(slot)
        return batch

    def _stage(self, name: str, items: int):
        return self.timer.stage(name, items) if self.timer is not None else contextlib.nullcontext()

    def _read_batch(self, batch_indices, pool, slots, stop) -> dict:
        n_valid = len(batch_indices)
        batch: dict = {"n_valid": n_valid, "indices": np.asarray(batch_indices)}
        prefetch = getattr(self.dataset, "prefetch", None)
        if prefetch is not None:
            with self._stage("prefetch", n_valid):
                prefetch(batch_indices)
        first = self.dataset[batch_indices[0]]
        buffers = {}
        for key, value in first.items():
            arr = np.asarray(value)
            shape = (self.batch_size, *arr.shape)
            if key == "image" and slots is not None:
                with self._stage("slot_wait", 0):
                    slot = slots.acquire(stop)
                if slot is None:
                    raise _Stopped
                buffers[key] = slot.buffer(shape, arr.dtype)
                batch["_slot"] = slot
            else:
                buffers[key] = np.empty(shape, arr.dtype)
            buffers[key][0] = arr

        def _fill(slot_idx: int) -> None:
            item = self.dataset[batch_indices[slot_idx]]
            for key, value in item.items():
                buffers[key][slot_idx] = value

        rest = range(1, n_valid)
        if pool is not None:
            list(pool.map(_fill, rest))
        else:
            for i in rest:
                _fill(i)
        for key, buf in buffers.items():
            if n_valid < self.batch_size:
                buf[n_valid:] = buf[n_valid - 1]
            batch[key] = buf
        return batch

    def _batches(self, slots: _SlotRing | None, pack_fn: Callable | None = None) -> Iterator[dict]:
        batch_indices_list = [
            self.indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(len(self))
        ]
        stop = threading.Event()
        if self.num_workers <= 0:
            for batch_indices in batch_indices_list:
                yield self._load_batch(batch_indices, None, slots, stop, pack_fn)
            return

        out_queue: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer() -> None:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for batch_indices in batch_indices_list:
                    if stop.is_set():
                        return
                    try:
                        out_queue.put(self._load_batch(batch_indices, pool, slots, stop, pack_fn))
                    except _Stopped:
                        return
                    except Exception as exc:  # handed to the consumer, which raises it
                        out_queue.put(exc)
                        return
                out_queue.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
            thread.join(timeout=5)

    def __iter__(self) -> Iterator[dict]:
        return self._batches(None)

    def iter_staged(
        self, stage_fn: Callable, *, pin_memory: bool = False, pack_fn: Callable | None = None
    ) -> Iterator[dict]:
        """Iterate batches with "image" replaced by ``stage_fn(image)``.

        With ``pin_memory`` the images are read into a ring of pinned host
        slots and handed to ``stage_fn`` as pinned CPU tensors, so its copy
        to a CUDA device can be asynchronous. ``stage_fn`` must return a
        CUDA tensor; the slot is reused after the work queued on that
        device's current stream when ``stage_fn`` returns. Without
        ``pin_memory``, ``stage_fn`` gets the numpy batch. ``pack_fn``, where
        given, turns each numpy batch into what ``stage_fn`` gets (pinned
        where the consumer is a card) on the reader thread; "wire" then
        counts its bytes.
        """
        slots = _SlotRing(self.prefetch + 2) if pin_memory else None
        for batch in self._batches(slots, pack_fn):
            slot = batch.pop("_slot", None)
            host = slot.tensor if slot is not None else batch["image"]
            with self._stage("wire", host.nbytes):
                batch["image"] = stage_fn(host)
            if slot is not None:
                slots.release(slot, batch["image"].device)
            yield batch


# -- the device-to-host drain (JAX ``parallel/pipeline.py:281-496``) -------------

_COPY_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_COPY_STREAMS_LOCK = threading.Lock()


def copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream of ``device`` that every drain's device-to-host copies queue on."""
    with _COPY_STREAMS_LOCK:
        stream = _COPY_STREAMS.get(device)
        if stream is None:
            stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
        return stream


def prepare_device(device: torch.device) -> None:
    """Make ready, before a loop queues work on ``device``, what would
    otherwise synchronise the CUDA context at the drain's first use after
    it: the copy stream (the stream pool's first use waits for the card) and
    the module of every kernel library (``_build.load_cuda_modules``), whose
    first launch, queued behind the loop's forwards, would wait for all of
    them (``scripts/probe_drain_syncs.py`` measures both)."""
    with torch.cuda.device(device):
        _build.load_cuda_modules()
    copy_stream(device)


class RowWatermark:
    """Completion tracker for an asynchronously filling row-major buffer (:281).

    Chunks may finish out of order; ``rows_ready`` is the contiguous prefix of
    rows that have landed. ``wait_rows(y)`` blocks until rows ``[0, y)`` are
    present; an error raised while copying is raised in every waiter.
    ``drain_seconds`` is the time from the tracker's creation to its last
    chunk, and ``finished_at`` the ``time.perf_counter()`` of that last chunk.
    """

    def __init__(self, slices: list, n_rows: int) -> None:
        self._cond = threading.Condition()
        self._slices = slices
        self._done = [False] * len(slices)
        self._prefix = 0
        self._n_rows = n_rows
        self.rows_ready = 0
        self.drain_seconds: float | None = None
        self.finished_at: float | None = None
        self.error: BaseException | None = None
        self._t0 = time.perf_counter()

    def _mark(self, idx: int) -> None:
        with self._cond:
            self._done[idx] = True
            while self._prefix < len(self._done) and self._done[self._prefix]:
                self._prefix += 1
            if self._prefix:
                self.rows_ready = self._slices[self._prefix - 1].stop
            if self._prefix == len(self._done):
                self.finished_at = time.perf_counter()
                self.drain_seconds = self.finished_at - self._t0
            self._cond.notify_all()

    def _fail(self, exc: BaseException) -> None:
        with self._cond:
            self.error = exc
            self._cond.notify_all()

    def wait_rows(self, y: int) -> None:
        target = min(int(y), self._n_rows)
        with self._cond:
            while self.rows_ready < target and self.error is None:
                self._cond.wait()
            if self.error is not None:
                raise self.error

    def wait_all(self) -> None:
        self.wait_rows(self._n_rows)


class _HostBuffer:
    """A drain's numpy buffer, over pinned memory where a card may copy into it."""

    def __init__(self, shape, dtype) -> None:
        dtype = np.dtype(dtype)
        self.pinned: torch.Tensor | None = None
        if torch.cuda.is_available():
            want = torch.from_numpy(np.empty(0, dtype)).dtype
            self.pinned = torch.empty(tuple(shape), dtype=want, pin_memory=True)
            self.array = self.pinned.numpy()
        else:
            self.array = np.empty(tuple(shape), dtype)

    def queue_copy(self, dev, rows: slice):
        """Queue the copy of ``dev`` into ``array[rows]`` and return what completes it.

        A CUDA tensor is copied on its device's copy stream after an event
        recorded on the stream that produced it, straight into the pinned
        buffer where the dtypes agree and otherwise into a pinned tensor of
        its own dtype; the allocator is told that the copy stream reads it.
        The returned callable waits for the copy's event (the wait lets go of
        the interpreter lock) and converts a chunk of another dtype. Anything
        else (a CPU tensor, a numpy array) is copied by the callable itself.
        """
        out = self.array
        if not (isinstance(dev, torch.Tensor) and dev.device.type == "cuda"):
            def complete_on_host() -> None:
                out[rows] = dev.numpy() if isinstance(dev, torch.Tensor) else np.asarray(dev)

            return complete_on_host
        direct = self.pinned is not None and self.pinned.dtype == dev.dtype
        host = self.pinned[rows] if direct else torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        stream = copy_stream(dev.device)
        written = torch.cuda.Event()
        written.record(torch.cuda.current_stream(dev.device))
        copied = torch.cuda.Event(blocking=True)
        stream.wait_event(written)
        with torch.cuda.stream(stream):
            host.copy_(dev, non_blocking=True)
            copied.record(stream)
        dev.record_stream(stream)

        def complete_on_card() -> None:
            copied.synchronize()
            if not direct:
                torch.from_numpy(out[rows]).copy_(host)

        return complete_on_card


def _complete_in_order(watermark: RowWatermark, jobs: list) -> None:
    """One daemon thread completes ``jobs`` (``(chunk index, callable)``) in order,
    marking each chunk; the first error fails the watermark."""

    def run() -> None:
        try:
            for idx, complete in jobs:
                complete()
                watermark._mark(idx)
        except BaseException as exc:  # noqa: BLE001 - raised again in every waiter
            watermark._fail(exc)

    threading.Thread(target=run, name="drain", daemon=True).start()


def fetch_chunked_async(tensor, n_chunks: int = 1, dtype=None) -> tuple[np.ndarray, RowWatermark]:
    """Start copying ``tensor`` to the host; return the filling buffer and its watermark (:328-368).

    The buffer has ``tensor``'s shape and ``dtype`` (the tensor's own by
    default; a float16 wire chunk lands in a pinned tensor of its own and
    is converted into a float32 buffer before its rows are marked). A CUDA
    tensor's ``n_chunks`` row chunks are copied on the device's copy stream
    after the work queued so far on the current stream, and one daemon
    thread waits for them in order and marks each; so host post-processing
    that gates on the watermark overlaps the copy. JAX's ``n_threads`` has
    no counterpart: the copies queue on one stream. The watermark is made
    first, so ``drain_seconds`` includes the pinned allocation. A CPU
    tensor is copied by the same thread.
    """
    n = int(tensor.shape[0])
    n_chunks = max(1, min(int(n_chunks), n))
    step = math.ceil(n / n_chunks) if n else 1
    slices = [slice(i, min(i + step, n)) for i in range(0, n, step)]
    watermark = RowWatermark(slices, n)
    if dtype is None:
        dtype = torch.empty(0, dtype=tensor.dtype).numpy().dtype
    out = _HostBuffer(tensor.shape, dtype)
    _complete_in_order(watermark, [(i, out.queue_copy(tensor[s], s)) for i, s in enumerate(slices)])
    return out.array, watermark


class BlockDrain:
    """Row-block device-to-host drain that can overlap a producing loop (:371-448).

    Canvas rows become final in band order, so each block of ``block_h``
    rows can be computed on the device (``block_fn(y0, rows)``, a tensor
    ``[rows, W, C]`` dispatched without a wait) and copied to the host as
    soon as ``advance`` learns that no later scatter touches it. Copies go
    as ``fetch_chunked_async``'s do: on the copy stream after an event,
    completed in order by a daemon thread per ``advance`` call that
    dispatched blocks. ``bytes_hidden`` is the bytes that had landed when
    ``flush`` was called.
    """

    def __init__(self, block_fn, n_rows: int, out_shape, out_dtype, block_h: int = 256) -> None:
        self._block_fn = block_fn
        self._n_rows = int(n_rows)
        self._slices = [
            slice(i, min(i + block_h, self._n_rows)) for i in range(0, self._n_rows, block_h)
        ]
        self._out = _HostBuffer(out_shape, out_dtype)
        self.buf = self._out.array
        self.watermark = RowWatermark(self._slices, self._n_rows)
        self._next = 0
        self.bytes_hidden = 0

    def advance(self, final_rows: int) -> None:
        """Dispatch every block not yet drained that lies inside ``[0, final_rows)``."""
        jobs = []
        while self._next < len(self._slices) and self._slices[self._next].stop <= final_rows:
            idx = self._next
            self._next += 1
            s = self._slices[idx]
            jobs.append((idx, self._out.queue_copy(self._block_fn(s.start, s.stop - s.start), s)))
        if jobs:
            _complete_in_order(self.watermark, jobs)

    def flush(self) -> None:
        """Dispatch every remaining block without waiting; consumers gate on
        ``watermark`` (or a ``LazyRowsView``)."""
        self.bytes_hidden = self.watermark.rows_ready * (self.buf.nbytes // max(self._n_rows, 1))
        self.advance(self._n_rows)

    def finish(self) -> np.ndarray:
        """Dispatch what remains, wait for every copy, return the full buffer."""
        self.flush()
        self.watermark.wait_all()
        return self.buf


class LazyRowsView:
    """Read-only channel slice of a filling buffer whose row reads wait for the rows (:451-496).

    ``view[y0:y1, ...]`` waits for rows ``[0, y1)``, an int row (negative
    too) for the rows up to it, any other index and ``np.asarray(view)`` for
    every row; then the rows are read from the buffer.
    """

    def __init__(self, buf: np.ndarray, watermark: RowWatermark, channels: slice) -> None:
        self._buf = buf
        self._wm = watermark
        self._ch = channels

    @property
    def shape(self) -> tuple:
        n_ch = len(range(*self._ch.indices(self._buf.shape[-1])))
        return (*self._buf.shape[:-1], n_ch)

    @property
    def dtype(self) -> np.dtype:
        return self._buf.dtype

    @property
    def ndim(self) -> int:
        return self._buf.ndim

    def __len__(self) -> int:
        return self._buf.shape[0]

    def __getitem__(self, key):
        rows = key[0] if isinstance(key, tuple) else key
        n = self._buf.shape[0]
        if isinstance(rows, slice):
            picked = range(*rows.indices(n))
            stop = max(picked[0], picked[-1]) + 1 if len(picked) else 0
        elif isinstance(rows, (int, np.integer)):
            stop = (int(rows) % n) + 1
        else:  # fancy indexing, an ellipsis: every row
            stop = n
        self._wm.wait_rows(stop)
        return self._buf[..., self._ch][key]

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002 - numpy's protocol
        self._wm.wait_all()
        arr = self._buf[..., self._ch]
        return arr.astype(dtype) if dtype is not None else arr
