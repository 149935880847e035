"""TIFF parsing, block decoding and a pyramid writer (counterpart of ``tiatoolbox_tpu/wsicore/tiffio.py``).

``TiffFile`` (:214) parses classic and BigTIFF files of either byte order
and decodes tiled or stripped pages, as the block decode at :386-460 does:
uncompressed, deflate (``zlib``), PackBits and LZW (the port's C++ in
``csrc/lzw.cpp``; on a malformed stream the pure-Python decoders
``_packbits_decode`` :196 and ``_lzw_decode`` :151), and JPEG with the
page's shared JPEGTables merged in (``_merge_jpeg_tables`` :132), through
the port's own baseline decoder (``csrc/jpegdec.cpp``, libjpeg-turbo's
pixels bit for bit) where JAX calls ``cv2.imdecode``. The tiles a region
touches decode in one threaded native batch (``_batch_decode_tiles``
:460-518), and ``prefetch_regions`` (:520-545) decodes the union of many
regions' tiles at once into the tile cache. JPEG 2000 tiles raise.
``TiffPyramidWriter`` (:670-800) writes JPEG tiles (the port's encoder,
``csrc/jpegenc.cpp``, the stream ``cv2.imencode`` writes) or deflate tiles.

``decode_counts`` counts the JPEG tiles decoded by native batches and one
at a time, over every file of the process.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import native

# TIFF tag ids used here.
TAG_NEW_SUBFILE_TYPE = 254
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_X_RESOLUTION = 282
TAG_Y_RESOLUTION = 283
TAG_PLANAR_CONFIG = 284
TAG_RESOLUTION_UNIT = 296
TAG_SOFTWARE = 305
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_JPEG_TABLES = 347

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_JPEG = 7
COMPRESSION_DEFLATE_ADOBE = 8
COMPRESSION_PACKBITS = 32773
COMPRESSION_DEFLATE = 32946
COMPRESSION_APERIO_J2K_YCBCR = 33003
COMPRESSION_APERIO_J2K_RGB = 33005

# TIFF field types: (struct format char, byte size)
_FIELD_TYPES = {
    1: ("B", 1),  # BYTE
    2: ("s", 1),  # ASCII
    3: ("H", 2),  # SHORT
    4: ("I", 4),  # LONG
    5: ("I", 4),  # RATIONAL (2 components per value)
    6: ("b", 1),  # SBYTE
    7: ("B", 1),  # UNDEFINED
    8: ("h", 2),  # SSHORT
    9: ("i", 4),  # SLONG
    10: ("i", 4),  # SRATIONAL (2 components per value)
    11: ("f", 4),  # FLOAT
    12: ("d", 8),  # DOUBLE
    16: ("Q", 8),  # LONG8 (BigTIFF)
    17: ("q", 8),  # SLONG8
    18: ("Q", 8),  # IFD8
}


@dataclass
class TiffPage:
    """One TIFF IFD: geometry, codec info, and tile/strip offsets."""

    index: int
    width: int = 0
    height: int = 0
    tile_width: int = 0
    tile_length: int = 0
    rows_per_strip: int = 0
    compression: int = COMPRESSION_NONE
    photometric: int = 2
    samples_per_pixel: int = 1
    bits_per_sample: tuple = (8,)
    sample_format: int = 1
    offsets: tuple = ()
    byte_counts: tuple = ()
    description: str = ""
    jpeg_tables: bytes | None = None
    subfile_type: int = 0
    x_resolution: float | None = None
    y_resolution: float | None = None
    resolution_unit: int = 2
    raw_tags: dict = field(default_factory=dict)

    @property
    def is_tiled(self) -> bool:
        return self.tile_width > 0

    @property
    def dtype(self) -> np.dtype:
        bits = self.bits_per_sample[0]
        if self.sample_format == 3:
            return np.dtype(f"float{bits}")
        if self.sample_format == 2:
            return np.dtype(f"int{bits}")
        return np.dtype(f"uint{bits}")

    @property
    def tiles_across(self) -> int:
        return -(-self.width // self.tile_width) if self.is_tiled else 1

    @property
    def tiles_down(self) -> int:
        if self.is_tiled:
            return -(-self.height // self.tile_length)
        return -(-self.height // max(self.rows_per_strip, 1))


_counts_lock = threading.Lock()
decode_counts = {"batch": 0, "single": 0}


def _count_decoded(path: str, n: int) -> None:
    with _counts_lock:
        decode_counts[path] += n


def reset_decode_counts() -> None:
    """Set both JPEG tile counts of ``decode_counts`` to 0."""
    with _counts_lock:
        for key in decode_counts:
            decode_counts[key] = 0


def _merge_jpeg_tables(tables: bytes, data: bytes) -> bytes:
    """Insert shared JPEGTables segments into an abbreviated JPEG stream.

    TIFF/EP stores quantisation+huffman tables once (tag 347) and each
    tile is an abbreviated stream. The merged stream is
    SOI + tables-body + tile-body (both stripped of SOI/EOI).
    """
    if not tables or len(tables) < 4:
        return data
    body = tables
    if body[:2] == b"\xff\xd8":
        body = body[2:]
    if body[-2:] == b"\xff\xd9":
        body = body[:-2]
    if data[:2] == b"\xff\xd8":
        return b"\xff\xd8" + body + data[2:]
    return b"\xff\xd8" + body + data


def _lzw_decode(data: bytes) -> bytes:
    """Decode TIFF-variant LZW (MSB-first, early-change)."""
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bitpos = 0
    bits = 9
    prev: bytes | None = None
    data_len = len(data) * 8

    def read_code() -> int:
        nonlocal bitpos
        if bitpos + bits > data_len:
            return 257  # EOI
        byte_idx = bitpos >> 3
        chunk = data[byte_idx : byte_idx + 4]
        val = int.from_bytes(chunk.ljust(4, b"\0"), "big")
        code = (val >> (32 - (bitpos & 7) - bits)) & ((1 << bits) - 1)
        bitpos += bits
        return code

    while True:
        code = read_code()
        if code == 256:  # Clear
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            bits = 9
            prev = None
            continue
        if code == 257:  # EOI
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # early change: bump width one code before the table fills
        if len(table) + 1 >= (1 << bits) and bits < 12:
            bits += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        header = data[i]
        i += 1
        if header > 128:
            if i < n:
                out += data[i : i + 1] * (257 - header)
                i += 1
        elif header < 128:
            out += data[i : i + header + 1]
            i += header + 1
        # 128 = no-op
    return bytes(out)


class TiffFile:
    """Parse a TIFF file and decode tile/strip/region data."""

    def __init__(self, path: str | Path, tile_cache_mb: int = 128) -> None:
        self.path = Path(path)
        # LRU cache of decoded tiles: grid reads touch each tile up to
        # 4x (patch grid vs tile grid misalignment); caching makes the
        # host tiling layer decode each tile exactly once.
        self._tile_cache: OrderedDict = OrderedDict()
        self._tile_cache_bytes = 0
        self._tile_cache_limit = tile_cache_mb * (1 << 20)
        self._cache_lock = threading.Lock()
        self._fh = self.path.open("rb")
        header = self._fh.read(8)
        if header[:2] == b"II":
            self.byteorder = "<"
        elif header[:2] == b"MM":
            self.byteorder = ">"
        else:
            msg = f"Not a TIFF file: {self.path}"
            raise ValueError(msg)
        magic = struct.unpack(self.byteorder + "H", header[2:4])[0]
        if magic == 42:
            self.bigtiff = False
            first_ifd = struct.unpack(self.byteorder + "I", header[4:8])[0]
        elif magic == 43:
            self.bigtiff = True
            rest = self._fh.read(8)
            first_ifd = struct.unpack(self.byteorder + "Q", rest[:8])[0]
        else:
            msg = f"Invalid TIFF magic: {magic}"
            raise ValueError(msg)
        self.pages: list[TiffPage] = []
        self._parse_ifds(first_ifd)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "TiffFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- parsing -------------------------------------------------------------

    def _read(self, offset: int, size: int) -> bytes:
        # os.pread is positional (no shared seek state), so threaded
        # readers can share the file handle.
        return os.pread(self._fh.fileno(), size, offset)

    def _parse_ifds(self, offset: int) -> None:
        bo = self.byteorder
        seen = set()
        while offset and offset not in seen:
            seen.add(offset)
            if self.bigtiff:
                n_entries = struct.unpack(bo + "Q", self._read(offset, 8))[0]
                entry_size, count_off = 20, offset + 8
            else:
                n_entries = struct.unpack(bo + "H", self._read(offset, 2))[0]
                entry_size, count_off = 12, offset + 2
            raw = self._read(count_off, n_entries * entry_size)
            tags: dict[int, object] = {}
            for i in range(n_entries):
                entry = raw[i * entry_size : (i + 1) * entry_size]
                tag_id, value = self._parse_entry(entry)
                if tag_id is not None:
                    tags[tag_id] = value
            next_off_pos = count_off + n_entries * entry_size
            if self.bigtiff:
                offset = struct.unpack(bo + "Q", self._read(next_off_pos, 8))[0]
            else:
                offset = struct.unpack(bo + "I", self._read(next_off_pos, 4))[0]
            self.pages.append(self._page_from_tags(len(self.pages), tags))

    def _parse_entry(self, entry: bytes):
        bo = self.byteorder
        if self.bigtiff:
            tag_id, ftype = struct.unpack(bo + "HH", entry[:4])
            count = struct.unpack(bo + "Q", entry[4:12])[0]
            inline = entry[12:20]
            inline_size = 8
        else:
            tag_id, ftype = struct.unpack(bo + "HH", entry[:4])
            count = struct.unpack(bo + "I", entry[4:8])[0]
            inline = entry[8:12]
            inline_size = 4
        if ftype not in _FIELD_TYPES:
            return None, None
        fmt, unit = _FIELD_TYPES[ftype]
        total = unit * count * (2 if ftype in (5, 10) else 1)
        if total <= inline_size:
            data = inline[:total]
        else:
            off_fmt = "Q" if self.bigtiff else "I"
            off = struct.unpack(bo + off_fmt, inline)[0]
            data = self._read(off, total)
        if ftype == 2:  # ASCII
            return tag_id, data.split(b"\0")[0].decode("latin-1", "replace")
        if ftype == 7:  # UNDEFINED → raw bytes
            return tag_id, data
        if ftype in (5, 10):  # RATIONAL
            vals = struct.unpack(bo + fmt * 2 * count, data)
            out = tuple(
                (vals[2 * i] / vals[2 * i + 1]) if vals[2 * i + 1] else 0.0
                for i in range(count)
            )
            return tag_id, out if count > 1 else out[0]
        vals = struct.unpack(bo + fmt * count, data)
        return tag_id, vals if count > 1 else vals[0]

    @staticmethod
    def _as_tuple(value) -> tuple:
        if isinstance(value, tuple):
            return value
        return (value,)

    def _page_from_tags(self, index: int, tags: dict) -> TiffPage:
        page = TiffPage(index=index)
        page.raw_tags = tags
        page.width = int(tags.get(TAG_IMAGE_WIDTH, 0))
        page.height = int(tags.get(TAG_IMAGE_LENGTH, 0))
        page.tile_width = int(tags.get(TAG_TILE_WIDTH, 0))
        page.tile_length = int(tags.get(TAG_TILE_LENGTH, 0))
        page.rows_per_strip = int(tags.get(TAG_ROWS_PER_STRIP, page.height or 1))
        page.compression = int(tags.get(TAG_COMPRESSION, COMPRESSION_NONE))
        page.photometric = int(tags.get(TAG_PHOTOMETRIC, 2))
        page.samples_per_pixel = int(tags.get(TAG_SAMPLES_PER_PIXEL, 1))
        page.bits_per_sample = self._as_tuple(tags.get(TAG_BITS_PER_SAMPLE, (8,)))
        sf = tags.get(TAG_SAMPLE_FORMAT, 1)
        page.sample_format = int(self._as_tuple(sf)[0])
        page.subfile_type = int(tags.get(TAG_NEW_SUBFILE_TYPE, 0))
        page.description = tags.get(TAG_IMAGE_DESCRIPTION, "") or ""
        page.jpeg_tables = tags.get(TAG_JPEG_TABLES)
        if page.is_tiled:
            page.offsets = self._as_tuple(tags.get(TAG_TILE_OFFSETS, ()))
            page.byte_counts = self._as_tuple(tags.get(TAG_TILE_BYTE_COUNTS, ()))
        else:
            page.offsets = self._as_tuple(tags.get(TAG_STRIP_OFFSETS, ()))
            page.byte_counts = self._as_tuple(tags.get(TAG_STRIP_BYTE_COUNTS, ()))
        if TAG_X_RESOLUTION in tags:
            page.x_resolution = float(tags[TAG_X_RESOLUTION])
        if TAG_Y_RESOLUTION in tags:
            page.y_resolution = float(tags[TAG_Y_RESOLUTION])
        page.resolution_unit = int(tags.get(TAG_RESOLUTION_UNIT, 2))
        return page

    # -- decoding --------------------------------------------------------------

    def _cache_get(self, key):
        with self._cache_lock:
            if key in self._tile_cache:
                self._tile_cache.move_to_end(key)
                return self._tile_cache[key]
        return None

    def _cache_put(self, key, tile: np.ndarray) -> None:
        with self._cache_lock:
            if key in self._tile_cache:
                return
            self._tile_cache[key] = tile
            self._tile_cache_bytes += tile.nbytes
            while self._tile_cache_bytes > self._tile_cache_limit and self._tile_cache:
                _, evicted = self._tile_cache.popitem(last=False)
                self._tile_cache_bytes -= evicted.nbytes

    def _decode_block(self, page: TiffPage, idx: int, shape: tuple[int, int]) -> np.ndarray:
        """Decode tile/strip ``idx`` of a page to an HxWxC array (cached)."""
        key = (page.index, idx)
        cached = self._cache_get(key)
        if cached is not None:
            return cached
        tile = self._decode_block_uncached(page, idx, shape)
        self._cache_put(key, tile)
        return tile

    def _decode_block_uncached(
        self, page: TiffPage, idx: int, shape: tuple[int, int]
    ) -> np.ndarray:
        """Decode tile/strip ``idx`` of a page to an HxWxC array."""
        h, w = shape
        spp = page.samples_per_pixel
        if idx >= len(page.offsets) or page.byte_counts[idx] == 0:
            return np.zeros((h, w, spp), dtype=page.dtype)
        data = self._read(page.offsets[idx], page.byte_counts[idx])
        comp = page.compression
        if comp == COMPRESSION_JPEG:
            stream = _merge_jpeg_tables(page.jpeg_tables or b"", data)
            try:
                arr = native.decode_jpeg(stream)
            except native.JpegDecodeError as exc:
                msg = f"JPEG decode failed for block {idx} of page {page.index}: {exc.reason}"
                raise ValueError(msg) from exc
            _count_decoded("single", 1)
            if arr.shape[2] == 1 and spp == 3:
                arr = np.repeat(arr, 3, axis=2)
        elif comp in (COMPRESSION_APERIO_J2K_YCBCR, COMPRESSION_APERIO_J2K_RGB):
            msg = f"JPEG 2000 TIFF tiles are not supported (compression {comp})."
            raise ValueError(msg)
        else:
            if comp == COMPRESSION_NONE:
                raw = data
            elif comp in (COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE):
                raw = zlib.decompress(data)
            elif comp in (COMPRESSION_PACKBITS, COMPRESSION_LZW):
                native_fn, python_fn = (
                    (native.packbits_decode, _packbits_decode)
                    if comp == COMPRESSION_PACKBITS
                    else (native.lzw_decode, _lzw_decode)
                )
                expected = h * w * spp * np.dtype(page.dtype).itemsize
                raw = native_fn(data, expected)
                if raw is None:  # malformed or overflowing: the Python decoder, as JAX
                    raw = python_fn(data)
            else:
                msg = f"Unsupported TIFF compression: {comp}"
                raise ValueError(msg)
            arr = np.frombuffer(raw, dtype=page.dtype)
            expect = h * w * spp
            if arr.size < expect:  # short final strip
                arr = np.pad(arr, (0, expect - arr.size))
            arr = arr[:expect].reshape(h, w, spp)
            if page.raw_tags.get(317) == 2:  # horizontal differencing predictor
                arr = np.cumsum(arr, axis=1, dtype=np.uint64).astype(page.dtype)
        # a JPEG stream may hold more or fewer pixels than the block: crop/pad
        if arr.shape[0] != h or arr.shape[1] != w:
            out = np.zeros((h, w, arr.shape[2]), dtype=arr.dtype)
            ch, cw = min(h, arr.shape[0]), min(w, arr.shape[1])
            out[:ch, :cw] = arr[:ch, :cw]
            arr = out
        return arr

    def _batch_decode_tiles(
        self, page: TiffPage, ix0: int, iy0: int, ix1: int, iy1: int
    ) -> dict[int, np.ndarray] | None:
        """Decode all JPEG tiles of a region at once with the native decoder.

        Returns {tile_index: array}, or None where the page is not JPEG (the
        caller then decodes tile by tile).
        """
        if page.compression != COMPRESSION_JPEG or page.samples_per_pixel not in (1, 3):
            return None
        tw, tl = page.tile_width, page.tile_length
        ta = page.tiles_across
        indices = [
            ty * ta + tx
            for ty in range(iy0 // tl, (iy1 - 1) // tl + 1)
            for tx in range(ix0 // tw, (ix1 - 1) // tw + 1)
        ]
        return self._batch_decode_indices(page, indices)

    def _batch_decode_indices(
        self, page: TiffPage, indices
    ) -> dict[int, np.ndarray] | None:
        """Decode the given tile indices in one native batch (cached).

        Fewer than 2 uncached tiles are left to the per-tile path.

        Raises:
            ValueError: a tile cannot be decoded; the message names it.
        """
        if page.compression != COMPRESSION_JPEG or page.samples_per_pixel not in (1, 3):
            return None
        tw, tl = page.tile_width, page.tile_length
        cached = {}
        for i in indices:
            tile = self._cache_get((page.index, i))
            if tile is not None:
                cached[i] = tile
        indices = [
            i
            for i in indices
            if i not in cached
            and i < len(page.offsets)
            and page.byte_counts[i] > 0
        ]
        if len(indices) < 2:  # not worth the batch setup
            return cached or None
        streams = [
            _merge_jpeg_tables(
                page.jpeg_tables or b"",
                self._read(page.offsets[i], page.byte_counts[i]),
            )
            for i in indices
        ]
        try:
            decoded = native.decode_jpeg_batch(streams, tl, tw, out_ch=page.samples_per_pixel)
        except native.JpegDecodeError as exc:
            msg = f"JPEG decode failed for block {indices[exc.index]} of page {page.index}: {exc.reason}"
            raise ValueError(msg) from exc
        _count_decoded("batch", len(indices))
        result = dict(cached)
        for k, idx in enumerate(indices):
            tile = decoded[k]
            result[idx] = tile
            self._cache_put((page.index, idx), tile)
        return result

    def prefetch_regions(self, page_index: int, bounds_list) -> None:
        """Batch-decode the JPEG tiles covering many regions at once.

        ``bounds_list``: iterable of (x0, y0, x1, y1) in page pixels. The
        union of touched tiles decodes in one threaded native call; later
        ``read_region`` calls hit the cache. No-op for non-JPEG pages.
        """
        page = self.pages[page_index]
        if page.compression != COMPRESSION_JPEG or not page.tile_width:
            return
        tw, tl = page.tile_width, page.tile_length
        ta = page.tiles_across
        wanted: set[int] = set()
        for x0, y0, x1, y1 in bounds_list:
            x0 = max(int(x0), 0)
            y0 = max(int(y0), 0)
            x1 = min(int(np.ceil(x1)), page.width)
            y1 = min(int(np.ceil(y1)), page.height)
            if x1 <= x0 or y1 <= y0:
                continue
            for ty in range(y0 // tl, (y1 - 1) // tl + 1):
                for tx in range(x0 // tw, (x1 - 1) // tw + 1):
                    wanted.add(ty * ta + tx)
        self._batch_decode_indices(page, sorted(wanted))

    def read_region(
        self,
        page_index: int,
        location: tuple[int, int],
        size: tuple[int, int],
        fill_value: int = 0,
    ) -> np.ndarray:
        """Read a (clamped, zero-padded) region from a page.

        Args:
            page_index: IFD index.
            location: (x, y) top-left in page coordinates.
            size: (width, height) of output.
            fill_value: value for out-of-page area.
        """
        page = self.pages[page_index]
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        spp = page.samples_per_pixel
        out = np.full((h, w, spp), fill_value, dtype=page.dtype)

        ix0, iy0 = max(x0, 0), max(y0, 0)
        ix1, iy1 = min(x0 + w, page.width), min(y0 + h, page.height)
        if ix1 <= ix0 or iy1 <= iy0:
            return out

        if page.is_tiled:
            tw, tl = page.tile_width, page.tile_length
            ta = page.tiles_across
            tile_cache = self._batch_decode_tiles(page, ix0, iy0, ix1, iy1)
            for ty in range(iy0 // tl, (iy1 - 1) // tl + 1):
                for tx in range(ix0 // tw, (ix1 - 1) // tw + 1):
                    idx = ty * ta + tx
                    if tile_cache is not None and idx in tile_cache:
                        tile = tile_cache[idx]
                    else:
                        tile = self._decode_block(page, idx, (tl, tw))
                    tx0, ty0_ = tx * tw, ty * tl
                    sx0, sy0 = max(ix0 - tx0, 0), max(iy0 - ty0_, 0)
                    sx1 = min(ix1 - tx0, tw)
                    sy1 = min(iy1 - ty0_, tl)
                    dx0, dy0 = tx0 + sx0 - x0, ty0_ + sy0 - y0
                    out[dy0 : dy0 + (sy1 - sy0), dx0 : dx0 + (sx1 - sx0)] = tile[
                        sy0:sy1, sx0:sx1
                    ]
        else:
            rps = page.rows_per_strip
            for si in range(iy0 // rps, (iy1 - 1) // rps + 1):
                strip_h = min(rps, page.height - si * rps)
                strip = self._decode_block(page, si, (strip_h, page.width))
                sy0 = max(iy0 - si * rps, 0)
                sy1 = min(iy1 - si * rps, strip_h)
                dy0 = si * rps + sy0 - y0
                out[dy0 : dy0 + (sy1 - sy0), ix0 - x0 : ix1 - x0] = strip[
                    sy0:sy1, ix0:ix1
                ]
        return out

    # -- pyramid/meta helpers ----------------------------------------------------

    def pyramid_pages(self) -> list[int]:
        """Indices of pages forming the main image pyramid (desc. size)."""
        if not self.pages:
            return []
        base = max(self.pages, key=lambda p: p.width * p.height)
        out = []
        for i, p in enumerate(self.pages):
            if p.width == 0 or p.samples_per_pixel != base.samples_per_pixel:
                continue
            # keep pages that are (close to) power-of-two reductions of base
            ratio = base.width / p.width
            if p is base or (
                abs(base.height / p.height - ratio) / ratio < 0.05 and p.is_tiled == base.is_tiled
            ):
                out.append(i)
        out.sort(key=lambda i: -self.pages[i].width)
        return out

    def svs_metadata(self) -> dict:
        """Extract mpp / objective power / vendor from page 0 metadata."""
        page = self.pages[0]
        desc = page.description
        meta: dict = {"vendor": None, "mpp": None, "objective_power": None}
        if desc.startswith("Aperio"):
            meta["vendor"] = "aperio"
        make = page.raw_tags.get(271, "")  # Make tag
        if isinstance(make, str) and "hamamatsu" in make.lower():
            # NDPI: vendor from Make, objective from private SourceLens tag
            meta["vendor"] = "hamamatsu"
            source_lens = page.raw_tags.get(65421)
            if source_lens is not None:
                try:
                    meta["objective_power"] = float(
                        source_lens[0]
                        if isinstance(source_lens, tuple)
                        else source_lens
                    )
                except (TypeError, ValueError):  # pragma: no cover
                    pass
        mpp_match = re.search(r"MPP\s*=\s*([\d.]+)", desc)
        if mpp_match:
            mpp = float(mpp_match.group(1))
            meta["mpp"] = (mpp, mpp)
        mag_match = re.search(r"AppMag\s*=\s*([\d.]+)", desc)
        if mag_match:
            meta["objective_power"] = float(mag_match.group(1))
        if meta["mpp"] is None and page.x_resolution:
            # ResolutionUnit: 2=inch, 3=cm
            if page.resolution_unit == 3 and page.x_resolution > 0:
                meta["mpp"] = (
                    10000.0 / page.x_resolution,
                    10000.0 / (page.y_resolution or page.x_resolution),
                )
            elif page.resolution_unit == 2 and page.x_resolution > 0:
                meta["mpp"] = (
                    25400.0 / page.x_resolution,
                    25400.0 / (page.y_resolution or page.x_resolution),
                )
        return meta


class TiffPyramidWriter:
    """Write a tiled pyramidal TIFF (classic, little-endian), ``tiffio.py:670-800``.

    Tiles are JPEG (``compression="jpeg"``, the default, at
    ``jpeg_quality``; RGB uint8 only, as ``cv2.imencode`` of a BGR tile is
    in JAX) or deflate (``"deflate"``). Each level is one IFD; level 0
    carries the description and resolution tags.
    """

    def __init__(
        self,
        path: str | Path,
        tile_size: int = 256,
        description: str = "",
        mpp: tuple[float, float] | None = None,
        compression: str = "jpeg",
        jpeg_quality: int = 90,
    ) -> None:
        if compression not in ("jpeg", "deflate"):
            msg = f"compression must be 'jpeg' or 'deflate', got {compression!r}."
            raise ValueError(msg)
        self.path = Path(path)
        self.tile_size = tile_size
        self.description = description
        self.mpp = mpp
        self.compression = compression
        self.jpeg_quality = jpeg_quality

    def _encode_tile(self, tile: np.ndarray) -> bytes:
        if self.compression == "jpeg":
            if tile.dtype != np.uint8 or tile.shape[2] != 3:
                msg = f"JPEG tiles are RGB uint8, got {tile.shape[2]} channels of {tile.dtype}."
                raise ValueError(msg)
            return native.encode_jpeg(tile, self.jpeg_quality)
        return zlib.compress(np.ascontiguousarray(tile).tobytes(), 6)

    def write(self, images: list[np.ndarray]) -> None:
        """Write the given pyramid levels (largest first)."""
        with self.path.open("wb") as fh:
            self._write_levels(fh, images)

    def _write_levels(self, fh, images: list[np.ndarray]) -> None:
        ts = self.tile_size
        fh.write(b"II*\x00")
        ifd_offset_pos = fh.tell()
        fh.write(struct.pack("<I", 0))  # patched later

        levels = []
        for img in images:
            if img.ndim == 2:
                img = img[:, :, None]
            h, w, c = img.shape

            def encode(origin, img=img, c=c) -> bytes:
                ty, tx = origin
                tile = np.zeros((ts, ts, c), dtype=img.dtype)
                block = img[ty * ts : (ty + 1) * ts, tx * ts : (tx + 1) * ts]
                tile[: block.shape[0], : block.shape[1]] = block
                return self._encode_tile(tile)

            # tiles are coded on one thread per core (zlib and the native
            # encoder release the interpreter lock) and written in order
            origins = [(ty, tx) for ty in range(-(-h // ts)) for tx in range(-(-w // ts))]
            offsets, counts = [], []
            with ThreadPoolExecutor(min(len(origins), os.cpu_count() or 1)) as pool:
                for data in pool.map(encode, origins):
                    offsets.append(fh.tell())
                    counts.append(len(data))
                    fh.write(data)
            levels.append((w, h, c, img.dtype, offsets, counts))

        # Write IFDs.
        prev_next_ptr = ifd_offset_pos
        for li, (w, h, c, dtype, offsets, counts) in enumerate(levels):
            ifd_start = self._write_ifd(
                fh, li, w, h, c, dtype, offsets, counts
            )
            # patch previous chain pointer
            end = fh.tell()
            fh.seek(prev_next_ptr)
            fh.write(struct.pack("<I", ifd_start))
            fh.seek(end)
            prev_next_ptr = self._next_ptr_pos

    def _write_ifd(self, fh, level, w, h, c, dtype, offsets, counts) -> int:
        entries: list[tuple[int, int, int, bytes]] = []  # (tag, type, count, payload)

        def add(tag: int, ftype: int, values) -> None:
            if isinstance(values, (int, float)):
                values = [values]
            if ftype == 2:  # ascii
                payload = values[0].encode("latin-1") + b"\0"
                entries.append((tag, 2, len(payload), payload))
                return
            if ftype == 5:  # rational
                payload = b"".join(
                    struct.pack("<II", int(v * 10000), 10000) for v in values
                )
                entries.append((tag, 5, len(values), payload))
                return
            fmt = {3: "H", 4: "I"}[ftype]
            payload = struct.pack("<" + fmt * len(values), *values)
            entries.append((tag, ftype, len(values), payload))

        bits = int(np.dtype(dtype).itemsize * 8)
        comp = COMPRESSION_JPEG if self.compression == "jpeg" else COMPRESSION_DEFLATE_ADOBE
        photometric = 6 if self.compression == "jpeg" else (2 if c == 3 else 1)
        add(TAG_NEW_SUBFILE_TYPE, 4, 0 if level == 0 else 1)
        add(TAG_IMAGE_WIDTH, 4, w)
        add(TAG_IMAGE_LENGTH, 4, h)
        add(TAG_BITS_PER_SAMPLE, 3, [bits] * c)
        add(TAG_COMPRESSION, 3, comp)
        add(TAG_PHOTOMETRIC, 3, photometric)
        if level == 0 and self.description:
            add(TAG_IMAGE_DESCRIPTION, 2, [self.description])
        add(TAG_SAMPLES_PER_PIXEL, 3, c)
        if level == 0 and self.mpp is not None:
            add(TAG_X_RESOLUTION, 5, [10000.0 / self.mpp[0]])
            add(TAG_Y_RESOLUTION, 5, [10000.0 / self.mpp[1]])
            add(TAG_RESOLUTION_UNIT, 3, 3)  # cm
        add(TAG_SOFTWARE, 2, ["tiatoolbox-tpu"])
        add(TAG_TILE_WIDTH, 3, self.tile_size)
        add(TAG_TILE_LENGTH, 3, self.tile_size)
        add(TAG_TILE_OFFSETS, 4, offsets)
        add(TAG_TILE_BYTE_COUNTS, 4, counts)
        entries.sort(key=lambda e: e[0])

        # Layout: [count][entries][next_ptr][out-of-line payloads]
        ifd_start = fh.tell()
        n = len(entries)
        overflow_start = ifd_start + 2 + n * 12 + 4
        entry_bytes = b""
        overflow = b""
        for tag, ftype, count, payload in entries:
            if len(payload) <= 4:
                inline = payload.ljust(4, b"\0")
            else:
                inline = struct.pack("<I", overflow_start + len(overflow))
                overflow += payload
            entry_bytes += struct.pack("<HHI", tag, ftype, count) + inline
        fh.write(struct.pack("<H", n))
        fh.write(entry_bytes)
        self._next_ptr_pos = fh.tell()
        fh.write(struct.pack("<I", 0))
        fh.write(overflow)
        return ifd_start
