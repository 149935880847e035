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
- ``csrc/png.cpp``: ``png_unfilter``, the five PNG row filters undone, for
  the port's PNG decoder (``utils/imagecodec.py``).
- ``csrc/j2kdec.cpp``: ``decode_j2k``, a JPEG 2000 codestream or JP2 file
  decoded whole, and ``decode_j2k_tiles``, listed tiles of one codestream
  each at its own size, on ``std::thread`` workers (the ``cv2.imdecode`` /
  ``cv2.imread`` of JAX's ``wsicore/jp2.py:229-244``, ``wsireader.py:1075-1108``,
  ``tiffio.py:416-422`` and ``dicom.py:361-375``). They give OpenJPEG 2.5's
  pixels bit for bit (cv2's decoder): the reversible 5/3 path, truncated
  code-blocks included, and the irreversible 9/7 path in OpenJPEG's float
  operations; a stream they cannot decode raises ``J2kDecodeError`` naming
  the feature or the fault. ``j2k_header`` reads the geometry without
  decoding.
- ``csrc/raster.cpp``: ``fill_poly``, ``polylines``, ``line`` and
  ``circle`` (filled), OpenCV's drawing at ``LINE_8`` into a uint8 canvas in place
  (``cv2.fillPoly``, ``cv2.polylines``, ``cv2.drawContours``, ``cv2.line``
  and ``cv2.circle`` of JAX's ``utils/visualization.py``), bit for bit with
  cv2 5.0 wherever the points lie, on or off the canvas.
- ``csrc/imgproc.cpp``: ``resize``, ``warp_affine``, ``remap``, ``blur`` and
  ``morphology``, OpenCV 5.0's ``cv2.resize`` (every interpolation JAX's
  ``imresize`` takes, and ``INTER_LINEAR_EXACT``), ``cv2.warpAffine`` and
  ``cv2.remap`` (bilinear, constant border), ``cv2.blur`` and
  ``cv2.erode`` / ``cv2.dilate`` / ``cv2.morphologyEx`` (open, close) with
  any structuring element, bit for bit with cv2 but for the resizes cv2
  hands to Intel IPP's cubic (``tests/test_torch_imgproc.py`` counts what
  differs). Large calls split their rows over threads; the result does not
  depend on how many.
- ``csrc/j2kenc.cpp``: ``encode_j2k``, a tiled codestream written in one
  pass (the role of the cv2 encodes JAX's ``jp2.py:319-384`` stitches):
  lossless by default, with test-stream options for every feature the
  decoder reads.
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
PNG = "png.cpp"
J2K_DECODER = "j2kdec.cpp"
J2K_ENCODER = "j2kenc.cpp"
RASTER = "raster.cpp"
IMGPROC = "imgproc.cpp"
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
    lib.jpeg_status_unsupported.argtypes = [i32]
    lib.jpeg_status_unsupported.restype = i32
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
    """A JPEG stream the decoder refused; ``index`` is its place in the batch
    and ``unsupported`` says whether the decoder lacks a feature that
    libjpeg-turbo has (``csrc/jpegdec.cpp`` ``jpeg_status_unsupported``),
    rather than the stream being corrupt."""

    def __init__(self, index: int, reason: str, *, unsupported: bool = False) -> None:
        super().__init__(f"JPEG decode failed for stream {index}: {reason}")
        self.index = index
        self.reason = reason
        self.unsupported = unsupported


def _jpeg_error(lib: ctypes.CDLL, index: int, code: int) -> JpegDecodeError:
    reason = lib.jpeg_status_message(code).decode()
    return JpegDecodeError(index, reason, unsupported=bool(lib.jpeg_status_unsupported(code)))


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


@functools.cache
def _png() -> ctypes.CDLL:
    lib = _build.load(PNG)
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    return lib


def png_unfilter(raw: np.ndarray, rows: int, row_bytes: int, bpp: int) -> np.ndarray | None:
    """Undo the row filters of ``rows`` PNG rows (a filter byte and
    ``row_bytes`` bytes each) with ``bpp`` bytes a pixel; ``None`` for an
    unknown filter type."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != rows * (row_bytes + 1):
        msg = f"png_unfilter: {raw.size} bytes for {rows} rows of {row_bytes} + 1."
        raise ValueError(msg)
    out = np.empty((rows, row_bytes), np.uint8)
    if _png().png_unfilter(_ptr(raw), rows, row_bytes, max(int(bpp), 1), _ptr(out)) != 0:
        return None
    return out


@functools.cache
def _j2k_decoder() -> ctypes.CDLL:
    lib = _build.load(J2K_DECODER)
    ptr, i32, u64, buf = ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_char_p
    lib.j2k_header.argtypes = [buf, u64, ptr, buf, i32]
    lib.j2k_header.restype = i32
    lib.j2k_decode_tiles.argtypes = [buf, u64, ptr, i32, ptr, ptr, i32, buf, i32]
    lib.j2k_decode_tiles.restype = i32
    lib.j2k_decode_batch.argtypes = [buf, ptr, ptr, i32, ptr, ptr, i32, ptr, buf, i32]
    lib.j2k_decode_batch.restype = i32
    return lib


@functools.cache
def _j2k_encoder() -> ctypes.CDLL:
    lib = _build.load(J2K_ENCODER)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.j2k_encode.argtypes = [ptr, i32, i32, i32, ptr, ctypes.c_double, i32, ptr, ctypes.c_char_p, i32]
    lib.j2k_encode.restype = ptr
    lib.j2k_encoded_copy.argtypes = [ptr, ptr]
    lib.j2k_encoded_copy.restype = None
    lib.j2k_encoded_free.argtypes = [ptr]
    lib.j2k_encoded_free.restype = None
    return lib


class J2kDecodeError(ValueError):
    """A JPEG 2000 stream the decoder refused: a feature it lacks (the
    message names it, after "unsupported JPEG 2000 feature") or a truncated
    or corrupt stream. ``index`` is the failing stream's place in a batch."""

    def __init__(self, message: str, index: int = 0) -> None:
        super().__init__(message)
        self.index = index


# j2k_header's fields (csrc/j2kdec.cpp)
J2K_HEADER_FIELDS = (
    "width", "height", "components", "x0", "y0", "tile_width", "tile_height", "tile_x0", "tile_y0",
    "tiles_across", "tiles_down",
)


def _j2k_call(fn, *args) -> None:
    err = ctypes.create_string_buffer(512)
    if fn(*args, err, len(err)) != 0:
        raise J2kDecodeError(err.value.decode(errors="replace"))


def j2k_header(stream: bytes) -> dict[str, int]:
    """Geometry of a JPEG 2000 codestream or JP2 file, read without decoding
    (the fields of ``J2K_HEADER_FIELDS``: image size and components, the
    image's origin, the tile size and the tile grid's origin and shape)."""
    stream = bytes(stream)
    info = np.zeros(len(J2K_HEADER_FIELDS), np.int64)
    _j2k_call(_j2k_decoder().j2k_header, stream, len(stream), _ptr(info))
    return dict(zip(J2K_HEADER_FIELDS, (int(v) for v in info)))


def _threads(n_threads: int | None, n: int) -> int:
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, MAX_DECODE_THREADS)
    return max(1, min(int(n_threads), MAX_DECODE_THREADS)) if n else 1


def decode_j2k(stream: bytes, n_threads: int | None = None) -> np.ndarray:
    """Decode a JPEG 2000 codestream or JP2 file to ``[h, w, c]`` uint8 (c 1
    or 3, in component order: RGB after the codestream's colour transform,
    as OpenJPEG gives it). Its tiles, or one tile's code-blocks, are shared
    out over ``n_threads`` workers (default ``min(cpu_count, 16)``).

    Raises:
        J2kDecodeError: (a ``ValueError``) an unsupported feature, named, or
            a truncated or corrupt stream.
    """
    try:
        return decode_j2k_batch([stream], _threads(n_threads, 1))[0]
    except J2kDecodeError as exc:
        raise J2kDecodeError(str(exc).removeprefix("stream 0: ")) from None


def decode_j2k_tiles(stream: bytes, indices, n_threads: int | None = None) -> list[np.ndarray]:
    """Decode tiles ``indices`` (raster order of the tile grid) of one
    codestream, each to ``[h, w, c]`` uint8 at its own size, on ``n_threads``
    workers (default ``min(cpu_count, len(indices), 16)``); the same errors
    as ``decode_j2k``."""
    stream = bytes(stream)
    info = j2k_header(stream)
    indices = np.ascontiguousarray(indices, np.int32).reshape(-1)
    across, down = info["tiles_across"], info["tiles_down"]
    if indices.size and (indices.min() < 0 or indices.max() >= across * down):
        msg = f"tile index out of range 0-{across * down - 1}: {indices.tolist()}"
        raise J2kDecodeError(msg)
    x_end, y_end = info["x0"] + info["width"], info["y0"] + info["height"]
    shapes = []
    for t in indices.tolist():
        i, j = t % across, t // across
        x0 = max(info["tile_x0"] + i * info["tile_width"], info["x0"])
        y0 = max(info["tile_y0"] + j * info["tile_height"], info["y0"])
        x1 = min(info["tile_x0"] + (i + 1) * info["tile_width"], x_end)
        y1 = min(info["tile_y0"] + (j + 1) * info["tile_height"], y_end)
        shapes.append((y1 - y0, x1 - x0, info["components"]))
    sizes = np.array([h * w * c for h, w, c in shapes], np.int64)
    offsets = np.zeros(len(shapes), np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    blob = np.empty(int(sizes.sum()), np.uint8)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, max(len(shapes), 1), MAX_DECODE_THREADS)
    _j2k_call(
        _j2k_decoder().j2k_decode_tiles, stream, len(stream), _ptr(indices), len(shapes), _ptr(blob),
        _ptr(offsets), _threads(n_threads, len(shapes)),
    )
    return [blob[o : o + s].reshape(shape) for o, s, shape in zip(offsets, sizes, shapes)]


def decode_j2k_batch(streams: list[bytes], n_threads: int | None = None) -> list[np.ndarray]:
    """Decode several codestreams (TIFF tiles, DICOM frames), each whole to
    ``[h, w, c]`` uint8, on ``n_threads`` workers (default ``min(cpu_count,
    len(streams), 16)``).

    Raises:
        J2kDecodeError: as ``decode_j2k``; ``index`` names the first failing
            stream.
    """
    streams = [bytes(s) for s in streams]
    shapes = []
    for k, s in enumerate(streams):
        try:
            info = j2k_header(s)
        except J2kDecodeError as exc:
            raise J2kDecodeError(f"stream {k}: {exc}", k) from None
        shapes.append((info["height"], info["width"], info["components"]))
    n = len(streams)
    sizes = np.array([len(s) for s in streams], np.int64)
    offsets = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    out_sizes = np.array([h * w * c for h, w, c in shapes], np.int64)
    out_offsets = np.zeros(n, np.int64)
    np.cumsum(out_sizes[:-1], out=out_offsets[1:])
    out = np.empty(int(out_sizes.sum()), np.uint8)
    if n == 0:
        return []
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, n, MAX_DECODE_THREADS)
    failed = ctypes.c_int32(-1)
    err = ctypes.create_string_buffer(512)
    blob = b"".join(streams)
    code = _j2k_decoder().j2k_decode_batch(
        blob, _ptr(offsets), _ptr(sizes), n, _ptr(out), _ptr(out_offsets), _threads(n_threads, n),
        ctypes.byref(failed), err, len(err),
    )
    if code != 0:
        raise J2kDecodeError(err.value.decode(errors="replace"), max(failed.value, 0))
    return [out[o : o + s].reshape(shape) for o, s, shape in zip(out_offsets, out_sizes, shapes)]


# encode_j2k's progression orders and code-block style bits (Table A.19)
J2K_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
J2K_BLOCK_STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vertical_causal": 8, "predictable": 16, "segsym": 32}


def encode_j2k(
    image: np.ndarray,
    tile_size: int | tuple[int, int] | None = None,
    *,
    levels: int = 5,
    irreversible: bool = False,
    step: float = 1.0,
    layers: int = 1,
    progression: str = "LRCP",
    precincts=None,
    cblk_style=(),
    code_block: tuple[int, int] = (64, 64),
    sop: bool = False,
    eph: bool = False,
    packets_per_tile_part: int = 0,
    mct: bool | None = None,
    n_threads: int | None = None,
) -> bytes:
    """A JPEG 2000 codestream of an ``[h, w, 3]`` RGB or ``[h, w]`` /
    ``[h, w, 1]`` grey uint8 image.

    The default is lossless: the reversible 5/3 transform, RCT on colour,
    ``levels`` decomposition levels, 64x64 code-blocks, one layer, LRCP,
    every coding pass kept, as ``cv2.imencode(".jp2", bgr,
    [IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])`` codes it. ``tile_size``
    (an int, or ``(width, height)``) sets a tile grid from (0, 0); the tiles
    are coded on ``n_threads`` workers. The other options make the streams
    the decoder's tests need: ``irreversible`` (9/7, ICT, expounded steps of
    ``step`` grey levels over OpenJPEG's band norms), ``layers`` (each
    code-block's passes shared out evenly), ``progression`` (one of
    ``J2K_PROGRESSIONS``), ``precincts`` (one ``(log2 width, log2 height)``
    for each resolution, the coarsest first), ``cblk_style`` (names of
    ``J2K_BLOCK_STYLES``), ``code_block`` sizes (powers of two), ``sop`` /
    ``eph`` markers, ``packets_per_tile_part``, and ``mct`` (the colour
    transform, on by default for colour images).

    Raises:
        ValueError: a bad image or option, or a coefficient that needs more
            bit-planes than the band has guard bits for.
    """
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] != 3):
        msg = f"encode_j2k takes [h, w, 3] RGB or [h, w] grey, got {image.shape}."
        raise ValueError(msg)
    h, w = image.shape[:2]
    if tile_size is None:
        tile_w = tile_h = 0
    else:
        tile_w, tile_h = (tile_size, tile_size) if np.isscalar(tile_size) else tile_size
    if progression not in J2K_PROGRESSIONS:
        msg = f"progression must be one of {J2K_PROGRESSIONS}, got {progression!r}."
        raise ValueError(msg)
    style = 0
    for name in cblk_style:
        if name not in J2K_BLOCK_STYLES:
            msg = f"unknown code-block style {name!r}; known: {sorted(J2K_BLOCK_STYLES)}."
            raise ValueError(msg)
        style |= J2K_BLOCK_STYLES[name]
    xcb, ycb = (int(np.log2(s)) for s in code_block)
    if [1 << xcb, 1 << ycb] != list(code_block):
        msg = f"code-block sides must be powers of two, got {code_block}."
        raise ValueError(msg)
    if mct is None:
        mct = image.ndim == 3
    opts = np.zeros(14 + 66, np.int32)
    opts[:14] = [
        tile_w, tile_h, levels, int(irreversible), layers, J2K_PROGRESSIONS.index(progression), style, int(sop),
        int(eph), xcb, ycb, packets_per_tile_part, precincts is not None, int(mct),
    ]
    if precincts is not None:
        if len(precincts) != levels + 1:
            msg = f"precincts needs one (log2 w, log2 h) for each of the {levels + 1} resolutions."
            raise ValueError(msg)
        for r, (px, py) in enumerate(precincts):
            opts[14 + r] = px
            opts[14 + 33 + r] = py
    if n_threads is None:
        n_threads = min(os.cpu_count() or 4, MAX_DECODE_THREADS)
    lib = _j2k_encoder()
    size = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(512)
    ch = 1 if image.ndim == 2 else 3
    handle = lib.j2k_encode(
        _ptr(image), h, w, ch, _ptr(opts), float(step), max(1, int(n_threads)), ctypes.byref(size), err, len(err)
    )
    if not handle:
        msg = f"encode_j2k: {err.value.decode(errors='replace')}"
        raise ValueError(msg)
    try:
        out = np.empty(size.value, np.uint8)
        lib.j2k_encoded_copy(handle, _ptr(out))
    finally:
        lib.j2k_encoded_free(handle)
    return out.tobytes()


@functools.cache
def _raster() -> ctypes.CDLL:
    lib = _build.load(RASTER)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.raster_fill_poly.argtypes = [ptr, i32, i32, i32, ptr, ptr, i32, ptr]
    lib.raster_fill_poly.restype = None
    lib.raster_polylines.argtypes = [ptr, i32, i32, i32, ptr, ptr, i32, i32, ptr, i32]
    lib.raster_polylines.restype = None
    lib.raster_line.argtypes = [ptr, i32, i32, i32, i32, i32, i32, i32, ptr, i32]
    lib.raster_line.restype = None
    lib.raster_circle.argtypes = [ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.raster_circle.restype = None
    return lib


def _canvas(img: np.ndarray) -> tuple[int, int, int]:
    """(h, w, channels) of a canvas the rasteriser can draw into in place."""
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
        msg = "the canvas must be a uint8 numpy array [h, w] or [h, w, c]."
        raise TypeError(msg)
    if not img.flags.c_contiguous or not img.flags.writeable:
        msg = "the canvas must be C-contiguous and writeable: it is drawn in place."
        raise ValueError(msg)
    cn = 1 if img.ndim == 2 else img.shape[2]
    if not 1 <= cn <= 4:
        msg = f"the canvas has 1 to 4 channels, got {cn}."
        raise ValueError(msg)
    return img.shape[0], img.shape[1], cn


def colour_bytes(color, channels: int) -> np.ndarray:
    """A colour as the canvas's bytes: each component rounded half to even and
    saturated to 0..255, missing components 0 (OpenCV's ``scalarToRawData``)."""
    values = np.zeros(4, np.float64)
    comps = np.asarray(color, np.float64).ravel()[:4]
    values[: comps.size] = comps
    return np.ascontiguousarray(np.clip(np.rint(values[:channels]), 0, 255).astype(np.uint8))


def _contours_arg(contours) -> tuple[np.ndarray, np.ndarray]:
    """int32 (x, y) points of every contour, one after the other, and their counts."""
    arrays = [np.asarray(c).reshape(-1, 2) for c in contours]
    for a in arrays:
        if a.dtype != np.int32:
            msg = f"contour points must be int32, as cv2 takes them, got {a.dtype}."
            raise TypeError(msg)
    counts = np.array([len(a) for a in arrays], np.int32)
    points = np.ascontiguousarray(np.concatenate(arrays) if arrays else np.zeros((0, 2), np.int32))
    return points, counts


def fill_poly(img: np.ndarray, contours, color) -> np.ndarray:
    """Fill the polygons ``contours`` (each int32 ``[k, 2]`` or ``[k, 1, 2]``
    (x, y)) into ``img`` with the even-odd rule, as ``cv2.fillPoly(img,
    contours, color)``; returns ``img``."""
    h, w, cn = _canvas(img)
    points, counts = _contours_arg(contours)
    if len(counts):
        _raster().raster_fill_poly(
            _ptr(img), h, w, cn, _ptr(points), _ptr(counts), len(counts), _ptr(colour_bytes(color, cn))
        )
    return img


def polylines(img: np.ndarray, contours, is_closed: bool, color, thickness: int = 1) -> np.ndarray:
    """Draw the polylines ``contours`` into ``img`` as ``cv2.polylines(img,
    contours, is_closed, color, thickness)``; ``cv2.drawContours(img,
    contours, -1, color, thickness)`` for ``thickness >= 1`` is the closed
    form. Returns ``img``."""
    h, w, cn = _canvas(img)
    if not 0 <= int(thickness) <= 32767:
        msg = f"thickness must be 0-32767, got {thickness}."
        raise ValueError(msg)
    points, counts = _contours_arg(contours)
    if len(counts):
        _raster().raster_polylines(
            _ptr(img), h, w, cn, _ptr(points), _ptr(counts), len(counts), int(bool(is_closed)),
            _ptr(colour_bytes(color, cn)), int(thickness),
        )
    return img


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """Draw a line with round caps, as ``cv2.line(img, pt1, pt2, color, thickness)``; returns ``img``."""
    h, w, cn = _canvas(img)
    if not 0 < int(thickness) <= 32767:
        msg = f"thickness must be 1-32767, got {thickness}."
        raise ValueError(msg)
    (x0, y0), (x1, y1) = (int(v) for v in pt1), (int(v) for v in pt2)
    _raster().raster_line(_ptr(img), h, w, cn, x0, y0, x1, y1, _ptr(colour_bytes(color, cn)), int(thickness))
    return img


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """Fill a circle, as ``cv2.circle(img, center, radius, color, -1)``; returns ``img``."""
    h, w, cn = _canvas(img)
    if int(radius) < 0:
        msg = f"radius must be non-negative, got {radius}."
        raise ValueError(msg)
    cx, cy = (int(v) for v in center)
    _raster().raster_circle(_ptr(img), h, w, cn, cx, cy, int(radius), _ptr(colour_bytes(color, cn)))
    return img


# ---------------------------------------------------------------- image processing

_IMGPROC_DEPTHS = {
    np.dtype(np.uint8): 0,
    np.dtype(np.uint16): 1,
    np.dtype(np.int16): 2,
    np.dtype(np.float32): 3,
    np.dtype(np.float64): 4,
}
# cv2's INTER_* numbers
RESIZE_INTERPOLATIONS = {"nearest": 0, "linear": 1, "cubic": 2, "area": 3, "linear_exact": 5}
# a call that reads and writes fewer elements runs on the calling thread
# (a 448^2 RGB patch: the engines' loader threads already run those in parallel)
IMGPROC_SERIAL_ELEMENTS = 1 << 20
_MORPH_OPS = {"erode": 0, "dilate": 1}


@functools.cache
def _imgproc() -> ctypes.CDLL:
    lib = _build.load(IMGPROC)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.imgproc_resize.argtypes = [ptr, i32, i32, i32, i32, ptr, i32, i32, i32, i32]
    lib.imgproc_warp_affine.argtypes = [ptr, i32, i32, i32, i32, ptr, i32, i32, ptr, ptr, i32]
    lib.imgproc_remap.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr, i32, i32, ptr, i32]
    lib.imgproc_blur.argtypes = [ptr, i32, i32, i32, i32, ptr, i32, i32, i32]
    lib.imgproc_morph.argtypes = [ptr, i32, i32, i32, ptr, ptr, i32, i32, i32, i32]
    for fn in (lib.imgproc_resize, lib.imgproc_warp_affine, lib.imgproc_remap, lib.imgproc_blur, lib.imgproc_morph):
        fn.restype = i32
    return lib


def imgproc_threads(n_elements: int, n_threads: int | None = None) -> int:
    """Threads for a call that reads and writes ``n_elements``: ``n_threads``
    if given, else 1 below ``IMGPROC_SERIAL_ELEMENTS`` and up to 16 above."""
    if n_threads is not None:
        return max(1, int(n_threads))
    if n_elements < IMGPROC_SERIAL_ELEMENTS:
        return 1
    return min(os.cpu_count() or 4, MAX_DECODE_THREADS)


def _image(image, what: str, depths=tuple(_IMGPROC_DEPTHS)) -> tuple[np.ndarray, int, int, int]:
    """A C-contiguous ``[h, w, c]`` view of an ``[h, w]`` or ``[h, w, c]`` image (1-4 channels)."""
    image = np.asarray(image)
    if image.dtype not in depths:
        names = [str(d) for d in depths]
        listed = names[0] if len(names) == 1 else f"{', '.join(names[:-1])} or {names[-1]}"
        msg = f"{what} takes {listed} images, got {image.dtype}."
        raise ValueError(msg)
    if image.ndim not in (2, 3) or 0 in image.shape:
        msg = f"{what} takes a non-empty [h, w] or [h, w, c] image, got shape {image.shape}."
        raise ValueError(msg)
    cn = 1 if image.ndim == 2 else image.shape[2]
    if not 1 <= cn <= 4:
        msg = f"{what} takes 1 to 4 channels, got {cn}."
        raise ValueError(msg)
    return np.ascontiguousarray(image), image.shape[0], image.shape[1], cn


def _shaped(out: np.ndarray, cn: int) -> np.ndarray:
    """``[h, w, 1]`` comes back ``[h, w]``, as from ``cv2``."""
    return out.reshape(out.shape[:2]) if cn == 1 else out


def _imgproc_call(fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        reason = {1: "the image type is not supported", 2: "unknown mode", 3: "empty size"}.get(code, f"code {code}")
        msg = f"{fn.__name__}: {reason}."
        raise ValueError(msg)


def resize(image: np.ndarray, dsize, interpolation: str, n_threads: int | None = None) -> np.ndarray:
    """``cv2.resize(image, dsize, interpolation=INTER_<interpolation>)``.

    Args:
        image: uint8, uint16, int16, float32 or float64 ``[h, w]`` or
            ``[h, w, c]`` (1-4 channels); ``linear_exact`` takes uint8 only.
        dsize: Output (width, height).
        interpolation: ``"nearest"``, ``"linear"``, ``"cubic"``, ``"area"`` or
            ``"linear_exact"``.
        n_threads: Threads (``imgproc_threads`` by default).

    Raises:
        ValueError: an unsupported type, shape, size or interpolation.
    """
    src, h, w, cn = _image(image, "resize")
    out_w, out_h = int(dsize[0]), int(dsize[1])
    if out_w < 1 or out_h < 1:
        msg = f"resize needs a positive output size, got {tuple(dsize)}."
        raise ValueError(msg)
    if interpolation not in RESIZE_INTERPOLATIONS:
        msg = f"Invalid interpolation: {interpolation}"
        raise ValueError(msg)
    out = np.empty((out_h, out_w, cn), src.dtype)
    threads = imgproc_threads(src.size + out.size, n_threads)
    _imgproc_call(
        _imgproc().imgproc_resize, _ptr(src), h, w, cn, _IMGPROC_DEPTHS[src.dtype], _ptr(out), out_h, out_w,
        RESIZE_INTERPOLATIONS[interpolation], threads,
    )
    return _shaped(out, cn)


def _border(border_value, cn: int) -> np.ndarray:
    """The border value per channel, as double: a scalar repeats, a longer
    sequence (cv2's four-value Scalar) gives its first ``cn``."""
    values = np.asarray(border_value, np.float64).ravel()
    return np.ascontiguousarray(np.broadcast_to(values[:cn], (cn,)), np.float64)


_WARP_DEPTHS = (np.dtype(np.uint8), np.dtype(np.float32), np.dtype(np.float64))


def warp_affine(image: np.ndarray, matrix, dsize, border_value=0, n_threads: int | None = None) -> np.ndarray:
    """``cv2.warpAffine(image, matrix, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`` of a uint8,
    float32 or float64 image; ``matrix`` is the 2x3 (or 3x3) forward affine."""
    src, h, w, cn = _image(image, "warp_affine", _WARP_DEPTHS)
    out_w, out_h = int(dsize[0]), int(dsize[1])
    if out_w < 1 or out_h < 1:
        msg = f"warp_affine needs a positive output size, got {tuple(dsize)}."
        raise ValueError(msg)
    m = np.ascontiguousarray(np.asarray(matrix, np.float64).reshape(-1)[:6])
    out = np.empty((out_h, out_w, cn), src.dtype)
    _imgproc_call(
        _imgproc().imgproc_warp_affine, _ptr(src), h, w, cn, _IMGPROC_DEPTHS[src.dtype], _ptr(out), out_h, out_w,
        _ptr(m), _ptr(_border(border_value, cn)), imgproc_threads(src.size + out.size, n_threads),
    )
    return _shaped(out, cn)


def remap(image: np.ndarray, map_x, map_y, border_value=0, n_threads: int | None = None) -> np.ndarray:
    """``cv2.remap(image, map_x, map_y, INTER_LINEAR, borderMode=BORDER_CONSTANT,
    borderValue=border_value)`` with float32 ``[h, w]`` maps of the output's shape."""
    src, h, w, cn = _image(image, "remap", _WARP_DEPTHS)
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.shape != map_y.shape or map_x.ndim != 2 or 0 in map_x.shape:
        msg = f"remap takes two [h, w] maps of one shape, not empty, got {map_x.shape} and {map_y.shape}."
        raise ValueError(msg)
    out_h, out_w = map_x.shape
    out = np.empty((out_h, out_w, cn), src.dtype)
    _imgproc_call(
        _imgproc().imgproc_remap, _ptr(src), h, w, cn, _IMGPROC_DEPTHS[src.dtype], _ptr(map_x), _ptr(map_y),
        _ptr(out), out_h, out_w, _ptr(_border(border_value, cn)), imgproc_threads(src.size + out.size, n_threads),
    )
    return _shaped(out, cn)


def blur(image: np.ndarray, ksize, n_threads: int | None = None) -> np.ndarray:
    """``cv2.blur(image, ksize)`` of a uint8, float32 or float64 image: the mean
    over a (width, height) ``ksize`` window anchored at ``ksize // 2``, the
    border reflected (101). A scalar ``ksize`` is square."""
    src, h, w, cn = _image(image, "blur", _WARP_DEPTHS)
    kw, kh = (int(ksize), int(ksize)) if np.ndim(ksize) == 0 else (int(ksize[0]), int(ksize[1]))
    if kw < 1 or kh < 1:
        msg = f"blur needs a positive kernel size, got {ksize}."
        raise ValueError(msg)
    out = np.empty(src.shape if src.ndim == 3 else (h, w, 1), src.dtype)
    _imgproc_call(
        _imgproc().imgproc_blur, _ptr(src), h, w, cn, _IMGPROC_DEPTHS[src.dtype], _ptr(out), kw, kh,
        imgproc_threads(2 * src.size, n_threads),
    )
    return _shaped(out, cn)


def morphology(
    image: np.ndarray,
    kernel,
    op: str,
    out: np.ndarray | None = None,
    work: np.ndarray | None = None,
    n_threads: int | None = None,
) -> np.ndarray:
    """``cv2.erode`` / ``cv2.dilate`` (``op`` ``"erode"``, ``"dilate"``) or
    ``cv2.morphologyEx`` (``"open"``, ``"close"``) of a uint8 (or bool,
    taken as 0/1) ``[h, w]`` or ``[h, w, c]`` image with the structuring
    element ``kernel`` (its non-zero pixels), the default anchor
    ``(kw // 2, kh // 2)`` and border: outside pixels neither clear an
    erosion nor set a dilation. An ``[h, w, 1]`` image comes back ``[h, w]``
    (a view of ``out``), as from ``cv2``.

    Args:
        out: uint8 C-contiguous array of the image's shape written and
            returned (it may be ``image`` itself); a new array without one.
        work: uint8 C-contiguous array of the image's shape that holds the
            first step of ``"open"`` and ``"close"``; a new one without it.
    """
    image = np.asarray(image)
    if image.dtype == np.bool_:
        image = image.view(np.uint8)
    src, h, w, cn = _image(image, "morphology", (np.dtype(np.uint8),))
    k = np.ascontiguousarray(np.asarray(kernel) != 0, np.uint8)
    if k.ndim != 2 or 0 in k.shape:
        msg = f"morphology takes a non-empty 2-D kernel, got shape {k.shape}."
        raise ValueError(msg)
    steps = {"erode": ("erode",), "dilate": ("dilate",), "open": ("erode", "dilate"), "close": ("dilate", "erode")}
    if op not in steps:
        msg = f"morphology op must be one of {sorted(steps)}, got {op!r}."
        raise ValueError(msg)
    for name, buf in (("out", out), ("work", work)):
        if buf is not None and (buf.dtype != np.uint8 or buf.shape != src.shape or not buf.flags.c_contiguous):
            msg = f"{name} must be a C-contiguous uint8 array of shape {src.shape}, got {buf.dtype} {buf.shape}."
            raise ValueError(msg)
    if out is None:
        out = np.empty(src.shape, np.uint8)
    if np.shares_memory(out, src):
        np.copyto(out, morphology(src, k, op, n_threads=n_threads).reshape(out.shape))
        return out
    threads = imgproc_threads(2 * src.size, n_threads)
    lib = _imgproc()
    first = steps[op][0]
    mid = out
    if len(steps[op]) == 2:
        mid = work if work is not None and not np.shares_memory(work, src) else np.empty(src.shape, np.uint8)
    _imgproc_call(lib.imgproc_morph, _ptr(src), h, w, cn, _ptr(mid), _ptr(k), k.shape[0], k.shape[1],
                  _MORPH_OPS[first], threads)
    if len(steps[op]) == 2:
        _imgproc_call(lib.imgproc_morph, _ptr(mid), h, w, cn, _ptr(out), _ptr(k), k.shape[0], k.shape[1],
                      _MORPH_OPS[steps[op][1]], threads)
    return out.reshape(h, w) if out.ndim == 3 and cn == 1 else out
