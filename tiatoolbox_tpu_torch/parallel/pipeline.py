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
passed an event recorded after that copy.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch


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
    ) -> dict:
        with self._stage("decode", len(batch_indices)):
            return self._read_batch(batch_indices, pool, slots, stop)

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

    def _batches(self, slots: _SlotRing | None) -> Iterator[dict]:
        batch_indices_list = [
            self.indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(len(self))
        ]
        stop = threading.Event()
        if self.num_workers <= 0:
            for batch_indices in batch_indices_list:
                yield self._load_batch(batch_indices, None, slots, stop)
            return

        out_queue: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer() -> None:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for batch_indices in batch_indices_list:
                    if stop.is_set():
                        return
                    try:
                        out_queue.put(self._load_batch(batch_indices, pool, slots, stop))
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
        self, stage_fn: Callable, *, pin_memory: bool = False
    ) -> Iterator[dict]:
        """Iterate batches with "image" replaced by ``stage_fn(image)``.

        With ``pin_memory`` the images are read into a ring of pinned host
        slots and handed to ``stage_fn`` as pinned CPU tensors, so its copy
        to a CUDA device can be asynchronous. ``stage_fn`` must return a
        CUDA tensor; the slot is reused after the work queued on that
        device's current stream when ``stage_fn`` returns. Without
        ``pin_memory``, ``stage_fn`` gets the numpy batch.
        """
        slots = _SlotRing(self.prefetch + 2) if pin_memory else None
        for batch in self._batches(slots):
            slot = batch.pop("_slot", None)
            host = slot.tensor if slot is not None else batch["image"]
            with self._stage("wire", host.nbytes):
                batch["image"] = stage_fn(host)
            if slot is not None:
                slots.release(slot, batch["image"].device)
            yield batch
