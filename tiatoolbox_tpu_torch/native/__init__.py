"""The port's host C++, loaded with ctypes (counterpart of ``tiatoolbox_tpu/native/__init__.py``).

Each source under ``csrc/`` is built with ``g++`` by ``_build.py`` into
``build_torch/`` at first use; a failed build raises, and nothing falls
back to another decoder.

- ``csrc/watershed.cpp``: ``watershed`` (JAX :131-156), the marker
  watershed of ``skimage.segmentation.watershed(image, markers,
  mask=mask)``, the image cast to float32 as JAX's wrapper casts it; and
  ``outer_contours``, the outer border of each instance of a label map, as
  ``cv2.findContours(RETR_TREE, CHAIN_APPROX_SIMPLE)[0][0]`` gives it on the
  instance's crop (``hovernet.py:555-558``).
- ``csrc/contours.cpp``: ``find_contours_ccomp``, the contours and two-level
  hierarchy of ``cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_SIMPLE)``
  (JAX's ``utils/store_conversion.py:82-117``), and ``find_contours_tree``,
  those of ``cv2.findContours(mask, RETR_TREE, CHAIN_APPROX_NONE)`` (JAX's
  ``models/architecture/hovernetplus.py:181-183``): the same points, contour
  order and hierarchy rows.
- ``csrc/jpegdec.cpp``: ``decode_jpeg_batch`` (JAX :153-189), the baseline
  JPEG decoder on ``std::thread`` workers, and ``decode_jpeg``, one stream at
  its own size (the ``cv2.imdecode`` of JAX's ``tiffio.py:406-415``). Both
  give libjpeg-turbo's pixels bit for bit; a stream they cannot decode
  raises ``ValueError`` naming it, where JAX's batch returns ``None`` and its
  per-tile ``cv2`` path raises on the same tile.
- ``csrc/jpegenc.cpp``: ``encode_jpeg``, the stream of ``cv2.imencode(".jpg",
  bgr, [IMWRITE_JPEG_QUALITY, q])`` (JAX's ``tiffio.py:694-704``).
- ``csrc/lzw.cpp``: ``lzw_decode`` and ``packbits_decode`` (JAX :192-219),
  ``None`` on a malformed stream or an overflow, so that the caller decodes
  with the pure-Python decoders as JAX's reader does.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from tiatoolbox_tpu_torch import _build

SOURCE = "watershed.cpp"
JPEG_DECODER = "jpegdec.cpp"
JPEG_ENCODER = "jpegenc.cpp"
TIFF_CODECS = "lzw.cpp"
CONTOURS = "contours.cpp"
# JAX's batch decoder takes min(cpu_count, n, 16) threads (its __init__.py:168-169)
MAX_DECODE_THREADS = 16


@functools.cache
def _library() -> ctypes.CDLL:
    """The built host library, its argument types set once per process."""
    lib = _build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.watershed_flood.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.watershed_flood.restype = i32
    lib.outer_contours.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, i64, ptr]
    lib.outer_contours.restype = i32
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def watershed(image: np.ndarray, markers: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Flood ``markers`` over ``image`` (ascending, first in first out on
    ties, 4-connected) inside ``mask``; int32 labels, 0 outside the mask."""
    image = np.ascontiguousarray(image, np.float32)
    markers32 = np.ascontiguousarray(markers, np.int32)
    mask8 = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if image.ndim != 2 or markers32.shape != image.shape or mask8.shape != image.shape:
        msg = f"image, markers and mask must be one 2-D shape, got {image.shape}, {markers32.shape}, {mask8.shape}."
        raise ValueError(msg)
    out = np.empty(image.shape, np.int32)
    _library().watershed_flood(
        _ptr(image), _ptr(markers32), _ptr(mask8), image.shape[0], image.shape[1], _ptr(out)
    )
    return out


def outer_contours(labels: np.ndarray, ids, starts, areas) -> list[np.ndarray]:
    """Outer border of each labelled instance, as int32 ``[k, 2]`` (x, y) points.

    Args:
        labels: int32 ``[H, W]`` label map.
        ids: the labels to trace.
        starts: ``[n, 2]`` (y, x) of each label's first pixel in raster order.
        areas: pixel count of each label (bounds the points it can have).

    Raises:
        RuntimeError: a contour had more points than its area allows.
    """
    labels = np.ascontiguousarray(labels, np.int32)
    ids = np.ascontiguousarray(ids, np.int32)
    starts = np.ascontiguousarray(starts, np.int32).reshape(-1, 2)
    if labels.ndim != 2 or len(starts) != len(ids):
        msg = f"labels [H, W] and one start per id expected, got {labels.shape}, {len(ids)} ids, {len(starts)} starts."
        raise ValueError(msg)
    # a pixel is passed at most 4 times, once between each pair of its 4-neighbours
    capacity = int(4 * np.sum(areas, dtype=np.int64) + 4 * len(ids))
    points = np.empty((max(capacity, 1), 2), np.int32)
    offsets = np.zeros(len(ids) + 1, np.int64)
    code = _library().outer_contours(
        _ptr(labels), labels.shape[0], labels.shape[1], len(ids), _ptr(ids), _ptr(starts),
        _ptr(points), capacity, _ptr(offsets),
    )
    if code != 0:
        msg = "outer_contours: a contour exceeded its point capacity."
        raise RuntimeError(msg)
    return [points[a:b].copy() for a, b in zip(offsets[:-1], offsets[1:])]


@functools.cache
def _contours() -> ctypes.CDLL:
    lib = _build.load(CONTOURS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.contours_trace.argtypes = [ptr, i32, i32, i32, ptr, ptr]
    lib.contours_trace.restype = ptr
    lib.contours_copy.argtypes = [ptr, ptr, ptr, ptr]
    lib.contours_copy.restype = None
    lib.contours_free.argtypes = [ptr]
    lib.contours_free.restype = None
    return lib


# ``contours_trace`` modes (csrc/contours.cpp)
_TREE = 1
_ALL_POINTS = 2


def _trace_contours(mask: np.ndarray, mode: int) -> tuple[list[np.ndarray], np.ndarray]:
    mask8 = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if mask8.ndim != 2:
        msg = f"mask must be 2-D, got shape {mask8.shape}."
        raise ValueError(msg)
    lib = _contours()
    n_contours, n_points = ctypes.c_int64(0), ctypes.c_int64(0)
    handle = lib.contours_trace(
        _ptr(mask8), mask8.shape[0], mask8.shape[1], mode, ctypes.byref(n_contours), ctypes.byref(n_points)
    )
    if not handle:
        msg = f"the contour tracer ran out of memory on a {mask8.shape} mask."
        raise MemoryError(msg)
    try:
        points = np.empty((max(n_points.value, 1), 2), np.int32)
        offsets = np.empty(n_contours.value + 1, np.int64)
        hierarchy = np.empty((n_contours.value, 4), np.int32)
        lib.contours_copy(handle, _ptr(points), _ptr(offsets), _ptr(hierarchy))
    finally:
        lib.contours_free(handle)
    return [points[a:b].copy() for a, b in zip(offsets[:-1], offsets[1:])], hierarchy


def find_contours_ccomp(mask: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
    """Outer borders and holes of a binary mask, as ``cv2.findContours(mask,
    RETR_CCOMP, CHAIN_APPROX_SIMPLE)`` gives them.

    Returns:
        The contours, each int32 ``[k, 2]`` (x, y) (cv2's ``[k, 1, 2]``
        squeezed), and the hierarchy, int32 ``[n, 4]`` rows of (next,
        previous, first child, parent), -1 for none (cv2's ``hierarchy[0]``).

    Raises:
        MemoryError: the tracer ran out of memory.
    """
    return _trace_contours(mask, 0)


def find_contours_tree(mask: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
    """Every border of a binary mask with its full nesting and every point, as
    ``cv2.findContours(mask, RETR_TREE, CHAIN_APPROX_NONE)`` gives them.

    The contours come in cv2's order, a pre-order walk of the tree, which
    differs from ``find_contours_ccomp``'s where holes hold islands.

    Returns:
        As ``find_contours_ccomp``.

    Raises:
        MemoryError: the tracer ran out of memory.
    """
    return _trace_contours(mask, _TREE | _ALL_POINTS)


@functools.cache
def _jpeg_decoder() -> ctypes.CDLL:
    lib = _build.load(JPEG_DECODER)
    ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64
    lib.jpeg_header.argtypes = [ctypes.c_char_p, u64, ptr]
    lib.jpeg_header.restype = i32
    lib.jpeg_status_message.argtypes = [i32]
    lib.jpeg_status_message.restype = ctypes.c_char_p
    lib.jpeg_decode_batch.argtypes = [ctypes.c_char_p, ptr, ptr, i32, ptr, i32, i32, i32, i32, ptr]
    lib.jpeg_decode_batch.restype = i32
    return lib


@functools.cache
def _jpeg_encoder() -> ctypes.CDLL:
    lib = _build.load(JPEG_ENCODER)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.jpeg_encode.argtypes = [ptr, i32, i32, i32, i32, ptr, ctypes.c_uint64]
    lib.jpeg_encode.restype = ctypes.c_int64
    return lib


@functools.cache
def _tiff_codecs() -> ctypes.CDLL:
    lib = _build.load(TIFF_CODECS)
    for fn in (lib.lzw_decode, lib.packbits_decode):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64]
        fn.restype = ctypes.c_int64
    return lib


class JpegDecodeError(ValueError):
    """A JPEG stream the decoder refused; ``index`` is its place in the batch."""

    def __init__(self, index: int, reason: str) -> None:
        super().__init__(f"JPEG decode failed for stream {index}: {reason}")
        self.index = index
        self.reason = reason


def _jpeg_error(lib: ctypes.CDLL, index: int, code: int) -> JpegDecodeError:
    return JpegDecodeError(index, lib.jpeg_status_message(code).decode())


def decode_jpeg_batch(
    streams: list[bytes],
    tile_h: int,
    tile_w: int,
    out_ch: int = 3,
    n_threads: int | None = None,
) -> np.ndarray:
    """Decode JPEG streams in parallel into ``[n, tile_h, tile_w, out_ch]`` uint8.

    Each stream's top-left ``min(h, tile_h)`` x ``min(w, tile_w)`` pixels are
    copied into a zeroed tile; ``out_ch`` 3 gives RGB (a grey stream
    replicated), 1 gives grey. ``n_threads`` defaults to ``min(cpu_count, n,
    16)``.

    Raises:
        JpegDecodeError: (a ``ValueError``) a stream cannot be decoded; it
            names the first such stream by its index and says why.
    """
    if out_ch not in (1, 3):
        msg = f"out_ch must be 1 or 3, got {out_ch}."
        raise ValueError(msg)
    n = len(streams)
    out = np.zeros((n, tile_h, tile_w, out_ch), np.uint8)
    if n == 0:
        return out
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, n, MAX_DECODE_THREADS)
    lib = _jpeg_decoder()
    blob = b"".join(streams)
    sizes = np.array([len(s) for s in streams], np.uint64)
    offsets = np.zeros(n, np.uint64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    status = np.zeros(n, np.int32)
    first = lib.jpeg_decode_batch(
        blob, _ptr(offsets), _ptr(sizes), n, _ptr(out), tile_h, tile_w, out_ch, n_threads, _ptr(status)
    )
    if first >= 0:
        raise _jpeg_error(lib, first, int(status[first]))
    return out


def decode_jpeg(stream: bytes) -> np.ndarray:
    """Decode one JPEG stream to ``[h, w, c]`` uint8 at its own size (c 1 or 3)."""
    lib = _jpeg_decoder()
    hwc = np.zeros(3, np.int32)
    code = lib.jpeg_header(stream, len(stream), _ptr(hwc))
    if code != 0:
        raise _jpeg_error(lib, 0, code)
    h, w, c = (int(v) for v in hwc)
    return decode_jpeg_batch([stream], h, w, out_ch=c, n_threads=1)[0]


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JPEG of an ``[h, w, 3]`` RGB or ``[h, w]`` / ``[h, w, 1]`` grey
    uint8 image at ``quality`` (1-100), as ``cv2.imencode`` writes it."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] != 3):
        msg = f"encode_jpeg takes [h, w, 3] RGB or [h, w] grey, got {image.shape}."
        raise ValueError(msg)
    h, w = image.shape[:2]
    ch = 1 if image.ndim == 2 else 3
    if not (0 < h <= 65535 and 0 < w <= 65535):
        msg = f"JPEG frames are 1-65535 pixels a side, got {h}x{w}."
        raise ValueError(msg)
    lib = _jpeg_encoder()
    cap = h * w * ch + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(_ptr(image), h, w, ch, int(quality), _ptr(out), cap)
        if n > 0:
            return out[:n].tobytes()
        if n == 0:
            msg = f"jpeg_encode refused a {h}x{w}x{ch} image."
            raise ValueError(msg)
        cap = -n


def _tiff_decode(fn, data: bytes, expected: int) -> bytes | None:
    out = np.empty(max(expected, 1), np.uint8)
    n = fn(data, len(data), _ptr(out), expected)
    return None if n < 0 else out[:n].tobytes()


def lzw_decode(data: bytes, expected: int) -> bytes | None:
    """TIFF LZW (MSB first, early change) into at most ``expected`` bytes;
    ``None`` on a malformed stream or an overflow."""
    return _tiff_decode(_tiff_codecs().lzw_decode, data, expected)


def packbits_decode(data: bytes, expected: int) -> bytes | None:
    """PackBits into at most ``expected`` bytes; ``None`` on an overflow."""
    return _tiff_decode(_tiff_codecs().packbits_decode, data, expected)
