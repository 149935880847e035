"""Chunked N-D array store (counterpart of ``tiatoolbox_tpu/utils/zarrlite.py:1-405``).

The zarr-v2 directory layout of JAX's module, byte for byte, so a store
written by either package opens in the other. Where JAX codes the chunks of
a read or write one after another, the port codes them on one thread per
core; the files are the same.

The reference relies on the ``zarr`` package for out-of-core spill of
inference canvases and for NGFF slides. That package is not part of
this build's dependency set, so this module implements the subset of
the zarr v2 *format* the framework needs, natively:

- directory store with ``.zarray`` / ``.zgroup`` / ``.zattrs`` JSON
- C-order chunks, files named ``i.j.k``
- raw or zlib-compressed chunks (numcodecs id "zlib"), so outputs are
  readable by standard zarr implementations and vice versa
- fill-value handling for missing chunks

Plus a ``smart_array`` allocator mirroring the reference's
``create_smart_array`` (``tiatoolbox/utils/misc.py:1964-2028``): NumPy
when it fits in free RAM, disk-backed ZarrArray otherwise.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_DTYPE_TO_ZARR = {
    "uint8": "|u1",
    "int8": "|i1",
    "bool": "|b1",
    "uint16": "<u2",
    "int16": "<i2",
    "uint32": "<u4",
    "int32": "<i4",
    "uint64": "<u8",
    "int64": "<i8",
    "float16": "<f2",
    "float32": "<f4",
    "float64": "<f8",
}


def _each(fn, items: list) -> None:
    """``fn`` over ``items``, on one thread per core where there are several:
    zlib and file I/O release the interpreter lock, so the chunks of one read
    or write are coded in parallel. Each item is one chunk of its own."""
    workers = min(len(items), os.cpu_count() or 1)
    if workers <= 1:
        for item in items:
            fn(item)
        return
    with ThreadPoolExecutor(workers) as pool:
        for _ in pool.map(fn, items):
            pass


def _zarr_dtype(dtype: np.dtype) -> str:
    name = np.dtype(dtype).name
    if name not in _DTYPE_TO_ZARR:
        msg = f"Unsupported dtype for zarrlite: {name}"
        raise TypeError(msg)
    return _DTYPE_TO_ZARR[name]


class ZarrArray:
    """A chunked, disk-backed N-D array using the zarr v2 layout.

    Supports integer and slice basic indexing for read and write.
    Thread-safety: concurrent writers to *different* chunks are safe
    (atomic file replace); same-chunk writes need external locking.
    """

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        meta = json.loads((self.path / ".zarray").read_text())
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value", 0)
        if self.fill_value is None:
            self.fill_value = 0
        comp = meta.get("compressor")
        self._compress = comp is not None
        self._clevel = (comp or {}).get("level", 1)
        if comp is not None and comp.get("id") != "zlib":
            msg = f"Unsupported compressor: {comp.get('id')}"
            raise ValueError(msg)
        self._sep = meta.get("dimension_separator", ".")

    # -- creation ----------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str | Path,
        shape: tuple[int, ...],
        chunks: tuple[int, ...] | None = None,
        dtype=np.float32,
        fill_value=0,
        *,
        compress: bool = True,
        overwrite: bool = False,
    ) -> "ZarrArray":
        path = Path(path)
        if path.exists():
            if not overwrite and (path / ".zarray").exists():
                msg = f"Array already exists at {path}"
                raise FileExistsError(msg)
            if overwrite:
                shutil.rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
        shape = tuple(int(v) for v in shape)
        if chunks is None:
            chunks = _default_chunks(shape, np.dtype(dtype))
        chunks = tuple(int(v) for v in chunks)
        meta = {
            "zarr_format": 2,
            "shape": list(shape),
            "chunks": list(chunks),
            "dtype": _zarr_dtype(dtype),
            "compressor": {"id": "zlib", "level": 1} if compress else None,
            "fill_value": (
                fill_value.item() if isinstance(fill_value, np.generic) else fill_value
            ),
            "order": "C",
            "filters": None,
            "dimension_separator": ".",
        }
        (path / ".zarray").write_text(json.dumps(meta))
        return cls(path)

    @classmethod
    def from_array(
        cls,
        path: str | Path,
        array: np.ndarray,
        chunks: tuple[int, ...] | None = None,
        *,
        compress: bool = True,
        overwrite: bool = False,
    ) -> "ZarrArray":
        out = cls.create(
            path,
            array.shape,
            chunks=chunks,
            dtype=array.dtype,
            compress=compress,
            overwrite=overwrite,
        )
        out[tuple(slice(None) for _ in array.shape)] = array
        return out

    # -- attrs -------------------------------------------------------------

    @property
    def attrs(self) -> dict:
        zattrs = self.path / ".zattrs"
        if zattrs.exists():
            return json.loads(zattrs.read_text())
        return {}

    @attrs.setter
    def attrs(self, value: dict) -> None:
        (self.path / ".zattrs").write_text(json.dumps(value))

    # -- chunk I/O ----------------------------------------------------------

    def _chunk_path(self, idx: tuple[int, ...]) -> Path:
        return self.path / self._sep.join(str(i) for i in idx)

    def _read_chunk(self, idx: tuple[int, ...]) -> np.ndarray:
        cpath = self._chunk_path(idx)
        if not cpath.exists():
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        raw = cpath.read_bytes()
        if self._compress:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, idx: tuple[int, ...], data: np.ndarray) -> None:
        raw = np.ascontiguousarray(data, dtype=self.dtype).tobytes()
        if self._compress:
            raw = zlib.compress(raw, self._clevel)
        cpath = self._chunk_path(idx)
        tmp = cpath.with_name(cpath.name + ".tmp")
        tmp.write_bytes(raw)
        tmp.replace(cpath)

    # -- indexing ------------------------------------------------------------

    def _normalize_key(self, key) -> tuple[list[slice], list[bool]]:
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > len(self.shape):
            msg = "Too many indices"
            raise IndexError(msg)
        key = key + tuple(slice(None) for _ in range(len(self.shape) - len(key)))
        slices: list[slice] = []
        squeeze: list[bool] = []
        for k, n in zip(key, self.shape):
            if isinstance(k, (int, np.integer)):
                kk = int(k)
                if kk < 0:
                    kk += n
                if not 0 <= kk < n:
                    msg = f"Index {k} out of range for axis of size {n}"
                    raise IndexError(msg)
                slices.append(slice(kk, kk + 1, 1))
                squeeze.append(True)
            elif isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    msg = "zarrlite supports step=1 slices only"
                    raise IndexError(msg)
                slices.append(slice(start, stop, 1))
                squeeze.append(False)
            else:
                msg = f"Unsupported index type: {type(k)}"
                raise IndexError(msg)
        return slices, squeeze

    def _chunk_range(self, slices: list[slice]):
        ranges = []
        for sl, c in zip(slices, self.chunks):
            first = sl.start // c
            last = max((sl.stop - 1) // c, first) if sl.stop > sl.start else first - 1
            ranges.append(range(first, last + 1))
        return itertools.product(*ranges)

    def __getitem__(self, key) -> np.ndarray:
        slices, squeeze = self._normalize_key(key)
        out_shape = tuple(sl.stop - sl.start for sl in slices)
        out = np.empty(out_shape, dtype=self.dtype)
        if 0 in out_shape:
            return out

        def load(cidx) -> None:
            chunk = self._read_chunk(cidx)
            src, dst = [], []
            for i, (sl, c) in enumerate(zip(slices, self.chunks)):
                c0 = cidx[i] * c
                lo = max(sl.start, c0)
                hi = min(sl.stop, c0 + c)
                src.append(slice(lo - c0, hi - c0))
                dst.append(slice(lo - sl.start, hi - sl.start))
            out[tuple(dst)] = chunk[tuple(src)]

        _each(load, list(self._chunk_range(slices)))
        for ax in reversed(range(len(squeeze))):
            if squeeze[ax]:
                out = out.reshape(out.shape[:ax] + out.shape[ax + 1 :])
        return out

    def __setitem__(self, key, value) -> None:
        slices, _ = self._normalize_key(key)
        sel_shape = tuple(sl.stop - sl.start for sl in slices)
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), sel_shape)
        if 0 in sel_shape:
            return

        def store(cidx) -> None:
            src, dst, full = [], [], True
            for i, (sl, c) in enumerate(zip(slices, self.chunks)):
                c0 = cidx[i] * c
                lo = max(sl.start, c0)
                hi = min(sl.stop, c0 + c)
                dst.append(slice(lo - c0, hi - c0))
                src.append(slice(lo - sl.start, hi - sl.start))
                if lo - c0 != 0 or hi - c0 != c:
                    full = False
            if full:
                chunk = np.empty(self.chunks, dtype=self.dtype)
            else:
                chunk = self._read_chunk(cidx)
            chunk[tuple(dst)] = value[tuple(src)]
            self._write_chunk(cidx, chunk)

        _each(store, list(self._chunk_range(slices)))

    # -- ndarray conveniences -------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __array__(self, dtype=None, copy=None) -> np.ndarray:  # noqa: ARG002 - a read is a copy
        out = self[tuple(slice(None) for _ in self.shape)]
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self) -> str:
        return (
            f"ZarrArray(shape={self.shape}, chunks={self.chunks}, "
            f"dtype={self.dtype}, path={self.path})"
        )


class ZarrGroup:
    """A zarr v2 group: named member arrays/groups plus JSON attrs."""

    def __init__(self, path: str | Path, *, create: bool = False) -> None:
        self.path = Path(path)
        zgroup = self.path / ".zgroup"
        if create:
            self.path.mkdir(parents=True, exist_ok=True)
            if not zgroup.exists():
                zgroup.write_text(json.dumps({"zarr_format": 2}))
        elif not zgroup.exists():
            msg = f"No zarr group at {self.path}"
            raise FileNotFoundError(msg)

    @classmethod
    def create(cls, path: str | Path) -> "ZarrGroup":
        return cls(path, create=True)

    @property
    def attrs(self) -> dict:
        zattrs = self.path / ".zattrs"
        return json.loads(zattrs.read_text()) if zattrs.exists() else {}

    @attrs.setter
    def attrs(self, value: dict) -> None:
        (self.path / ".zattrs").write_text(json.dumps(value))

    def keys(self) -> list[str]:
        out = []
        for child in sorted(self.path.iterdir()):
            if (child / ".zarray").exists() or (child / ".zgroup").exists():
                out.append(child.name)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.keys()

    def __getitem__(self, name: str):
        child = self.path / name
        if (child / ".zarray").exists():
            return ZarrArray(child)
        if (child / ".zgroup").exists():
            return ZarrGroup(child)
        msg = f"No member {name!r} in group {self.path}"
        raise KeyError(msg)

    def create_array(self, name: str, **kwargs) -> ZarrArray:
        return ZarrArray.create(self.path / name, **kwargs)

    def create_group(self, name: str) -> "ZarrGroup":
        return ZarrGroup(self.path / name, create=True)

    def from_array(self, name: str, array: np.ndarray, **kwargs) -> ZarrArray:
        return ZarrArray.from_array(self.path / name, array, **kwargs)


def open_zarr(path: str | Path):
    """Open a path as a ZarrArray or ZarrGroup."""
    path = Path(path)
    if (path / ".zarray").exists():
        return ZarrArray(path)
    if (path / ".zgroup").exists():
        return ZarrGroup(path)
    msg = f"Not a zarr array or group: {path}"
    raise FileNotFoundError(msg)


def _default_chunks(shape: tuple[int, ...], dtype: np.dtype) -> tuple[int, ...]:
    """Pick chunk sizes targeting ~4 MiB per chunk, trailing dims whole."""
    target = 4 * 1024 * 1024 // max(dtype.itemsize, 1)
    chunks = list(shape)
    # shrink leading dims first
    for i in range(len(shape)):
        current = int(np.prod(chunks))
        if current <= target:
            break
        shrink = math.ceil(current / target)
        chunks[i] = max(1, chunks[i] // shrink)
    return tuple(chunks)


def free_ram_bytes() -> int:
    """Available system memory in bytes (``MemAvailable``; 8 GiB if unknown)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def create_smart_array(
    shape: tuple[int, ...],
    dtype=np.float32,
    save_dir: str | Path | None = None,
    memory_fraction: float = 0.5,
    name: str = "smart_array",
):
    """Allocate NumPy in RAM or a disk-backed ZarrArray when too large.

    Mirrors reference ``utils/misc.py:1964-2028``: if the array would
    use more than ``memory_fraction`` of available RAM, spill to disk.
    """
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes <= free_ram_bytes() * memory_fraction or save_dir is None:
        return np.zeros(shape, dtype=dtype)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    return ZarrArray.create(
        save_dir / f"{name}.zarr", shape, dtype=dtype, fill_value=0, overwrite=True
    )
