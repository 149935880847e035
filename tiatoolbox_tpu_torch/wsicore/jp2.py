"""JPEG 2000 codestream tooling: windowed tile reads (counterpart of ``tiatoolbox_tpu/wsicore/jp2.py``).

``J2KCodestream`` parses the main header and indexes the tile-parts as
JAX's does (:56-154, copied), and ``extract_tile_codestream`` (:156-200)
writes JAX's bytes. Decoding differs in how, not in what: JAX wraps each
tile in a mini codestream for ``cv2.imdecode``; the port's decoder
(``native.decode_j2k_tiles``, ``csrc/j2kdec.cpp``) decodes the tiles of the
one codestream in place, at their absolute coordinates, several on threads.
A tile read at ``reduce`` 2, 4 or 8 is the full decode shrunk to the
floored size with OpenCV's ``INTER_LINEAR_EXACT``
(``utils.transforms.shrink_linear_exact``), which is what
``cv2.IMREAD_REDUCED_*`` gives; ``read_region`` (:246-300) keeps JAX's
arithmetic, so a ragged last tile leaves the same zero edge.

``encode_tiled_j2k`` / ``write_tiled_jp2`` (:319-384) write a multi-tile
codestream with the port's encoder (``native.encode_j2k``) in one pass,
lossless; JAX stitches tiles cv2 encoded at its lossy default. A
``quality`` would need OpenJPEG's rate allocation, which the port lacks.
``jp2_container`` wraps a codestream in JP2 boxes with a ``resc`` box, so
that a file carries its mpp (which ``JP2WSIReader`` reads as JAX's does).
"""

from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.utils.transforms import shrink_linear_exact

SOC = 0xFF4F
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
TLM = 0xFF55
PLM = 0xFF57
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
CRG = 0xFF63
COM = 0xFF64
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9

# main-header segments that stay valid after tile extraction
_KEEP_IN_MAIN = {COD, COC, QCD, QCC, RGN, POC, CRG, COM}

# decoded tiles kept by one codestream (JAX :211)
TILE_CACHE_BYTES = 64 << 20


@dataclass
class TilePart:
    """One SOT..(next SOT|EOC) segment of a tile."""

    offset: int  # offset of the SOT marker in the codestream
    length: int  # full tile-part length (Psot)
    tpsot: int


@dataclass
class J2KCodestream:
    """Parsed J2K codestream with a tile index for windowed decoding."""

    data: bytes  # full codestream bytes (SOC..EOC)
    xsiz: int = 0
    ysiz: int = 0
    xosiz: int = 0
    yosiz: int = 0
    xtsiz: int = 0
    ytsiz: int = 0
    xtosiz: int = 0
    ytosiz: int = 0
    n_components: int = 0
    siz_offset: int = 0
    siz_length: int = 0
    main_segments: list = field(default_factory=list)  # (marker, off, seglen)
    tiles: dict = field(default_factory=dict)  # Isot -> [TilePart]
    has_ppm: bool = False

    # -- parsing (JAX :76-125) ---------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes) -> "J2KCodestream":
        if data[:2] != b"\xff\x4f":
            # jp2 container: locate the jp2c box payload
            idx = data.find(b"jp2c")
            if idx < 0:
                msg = "Not a J2K codestream or JP2 container."
                raise ValueError(msg)
            data = data[idx + 4 :]
            soc = data.find(b"\xff\x4f\xff\x51")
            if soc < 0:
                msg = "JP2 container holds no codestream."
                raise ValueError(msg)
            data = data[soc:]
        cs = cls(data=data)
        cs._parse()
        return cs

    def _parse(self) -> None:
        data = self.data
        off = 2  # past SOC
        n = len(data)
        while off + 4 <= n:
            marker = struct.unpack_from(">H", data, off)[0]
            if marker == SOT:
                break
            seglen = struct.unpack_from(">H", data, off + 2)[0]
            if marker == SIZ:
                self.siz_offset = off
                self.siz_length = seglen
                (
                    _rsiz, self.xsiz, self.ysiz, self.xosiz, self.yosiz,
                    self.xtsiz, self.ytsiz, self.xtosiz, self.ytosiz,
                    self.n_components,
                ) = struct.unpack_from(">HIIIIIIIIH", data, off + 4)
            elif marker == PPM:
                self.has_ppm = True
            elif marker in _KEEP_IN_MAIN:
                self.main_segments.append((marker, off, seglen))
            off += 2 + seglen
        # index tile-parts
        while off + 12 <= n:
            marker = struct.unpack_from(">H", data, off)[0]
            if marker == EOC:
                break
            if marker != SOT:
                msg = f"Unexpected marker {marker:04x} in tile stream."
                raise ValueError(msg)
            _lsot, isot, psot, tpsot, _tnsot = struct.unpack_from(">HHIBB", data, off + 2)
            if psot == 0:  # last tile-part extends to EOC
                psot = n - 2 - off
            self.tiles.setdefault(isot, []).append(TilePart(off, psot, tpsot))
            off += psot

    # -- tile grid (JAX :127-146) --------------------------------------------

    @property
    def grid_shape(self) -> tuple[int, int]:
        """(tiles_x, tiles_y)."""
        tx = -(-(self.xsiz - self.xtosiz) // self.xtsiz)
        ty = -(-(self.ysiz - self.ytosiz) // self.ytsiz)
        return tx, ty

    @property
    def image_size(self) -> tuple[int, int]:
        """(width, height) of the image area."""
        return self.xsiz - self.xosiz, self.ysiz - self.yosiz

    def tile_bounds(self, index: int) -> tuple[int, int, int, int]:
        """Absolute (x0, y0, x1, y1) of a tile, clipped to the image."""
        tx, _ty = self.grid_shape
        i, j = index % tx, index // tx
        x0 = max(self.xtosiz + i * self.xtsiz, self.xosiz)
        y0 = max(self.ytosiz + j * self.ytsiz, self.yosiz)
        x1 = min(self.xtosiz + (i + 1) * self.xtsiz, self.xsiz)
        y1 = min(self.ytosiz + (j + 1) * self.ytsiz, self.ysiz)
        return x0, y0, x1, y1

    @property
    def decomposition_levels(self) -> int:
        """DWT levels from the main-header COD (SPcod byte)."""
        for marker, off, _seglen in self.main_segments:
            if marker == COD:
                # COD: marker(2) Lcod(2) Scod(1) SGcod(4) SPcod levels(1)
                return self.data[off + 9]
        return 5  # spec-common default

    def extract_tile_codestream(self, index: int) -> bytes:
        """Minimal standalone codestream holding only tile ``index``, byte for
        byte JAX's (:156-200): SIZ rewritten to the tile at origin (0, 0).

        Raises:
            ValueError: PPM, or a tile origin not a multiple of
                ``2**decomposition_levels``.
            KeyError: the tile is absent.
        """
        if self.has_ppm:
            msg = "PPM (packed packet headers) unsupported for extraction."
            raise ValueError(msg)
        if index not in self.tiles:
            msg = f"Tile {index} absent from codestream."
            raise KeyError(msg)
        x0, y0, x1, y1 = self.tile_bounds(index)
        align = 1 << self.decomposition_levels
        if x0 % align or y0 % align:
            msg = (
                f"Tile origin ({x0}, {y0}) not aligned to 2^levels={align}; "
                "origin rebase would change DWT grids."
            )
            raise ValueError(msg)
        data = self.data
        out = bytearray(b"\xff\x4f")  # SOC
        siz = bytearray(data[self.siz_offset : self.siz_offset + 2 + self.siz_length])
        struct.pack_into(">IIIIIIII", siz, 6, x1 - x0, y1 - y0, 0, 0, max(x1 - x0, 1), max(y1 - y0, 1), 0, 0)
        out += siz
        for _marker, off, seglen in self.main_segments:
            out += data[off : off + 2 + seglen]
        for part in self.tiles[index]:
            seg = bytearray(data[part.offset : part.offset + part.length])
            struct.pack_into(">H", seg, 4, 0)  # Isot -> 0
            struct.pack_into(">I", seg, 6, part.length)  # explicit Psot
            out += seg
        out += b"\xff\xd9"  # EOC
        return bytes(out)

    # -- decoding ------------------------------------------------------------

    def _cache(self) -> tuple[OrderedDict, threading.Lock]:
        """The decoded-tile LRU and the lock that guards it: a slide's
        reader threads decode through one codestream."""
        state = self.__dict__
        return state.setdefault("_tile_cache", OrderedDict()), state.setdefault("_tile_lock", threading.Lock())

    def decode_tile(self, index: int, reduce: int = 1) -> np.ndarray:
        """Decode one tile (RGB or grey uint8), at 1/reduce scale (1, 2, 4, 8).

        Decoded tiles are LRU-cached (64 MB) as in JAX (:202-216).
        """
        return self.decode_tiles([index], reduce)[0]

    def decode_tiles(self, indices, reduce: int = 1) -> list[np.ndarray]:
        """Decode several tiles, those not cached in one threaded native call."""
        if reduce not in (1, 2, 4, 8):
            msg = f"reduce must be 1, 2, 4 or 8, got {reduce}."
            raise ValueError(msg)
        cache, lock = self._cache()
        keys = [(index, reduce) for index in indices]
        with lock:
            tiles = {key: cache[key] for key in keys if key in cache}
        missing = [key[0] for key in dict.fromkeys(keys) if key not in tiles]
        if missing:  # decoded outside the lock, so readers decode in parallel
            tiles.update(zip([(index, reduce) for index in missing], self._decode_tiles_uncached(missing, reduce)))
        with lock:
            for key in keys:
                cache[key] = tiles[key]
                cache.move_to_end(key)
            while sum(v.nbytes for v in cache.values()) > TILE_CACHE_BYTES and len(cache) > 1:
                cache.popitem(last=False)
        return [tiles[key] for key in keys]

    def _decode_tiles_uncached(self, indices: list[int], reduce: int) -> list[np.ndarray]:
        for index in indices:
            if index not in self.tiles:
                msg = f"Tile {index} absent from codestream."
                raise KeyError(msg)
        tiles = native.decode_j2k_tiles(self.data, indices)
        out = []
        for tile in tiles:
            if reduce != 1:
                tile = shrink_linear_exact(tile, reduce)
            out.append(tile[:, :, 0] if self.n_components == 1 else tile)
        return out

    def read_region(self, location: tuple[int, int], size: tuple[int, int], reduce: int = 1) -> np.ndarray:
        """Decode a window (image-area coords at full res) via its tiles
        (JAX :246-300: the same placement, ceil-sized output)."""
        x, y = location
        w, h = size
        gx0 = self.xosiz + x
        gy0 = self.yosiz + y
        gx1, gy1 = gx0 + w, gy0 + h
        tx, ty = self.grid_shape
        i0 = max((gx0 - self.xtosiz) // self.xtsiz, 0)
        j0 = max((gy0 - self.ytosiz) // self.ytsiz, 0)
        i1 = min(-(-(gx1 - self.xtosiz) // self.xtsiz), tx)
        j1 = min(-(-(gy1 - self.ytosiz) // self.ytsiz), ty)
        out_w = -(-w // reduce)
        out_h = -(-h // reduce)
        channels = 1 if self.n_components == 1 else 3
        shape = (out_h, out_w, channels) if channels > 1 else (out_h, out_w)
        out = np.zeros(shape, np.uint8)
        indices = []
        for j in range(j0, j1):
            for i in range(i0, i1):
                index = j * tx + i
                tx0, ty0, tx1, ty1 = self.tile_bounds(index)
                if min(gx1, tx1) > max(gx0, tx0) and min(gy1, ty1) > max(gy0, ty0):
                    indices.append(index)
        for index, tile in zip(indices, self.decode_tiles(indices, reduce)):
            tx0, ty0, tx1, ty1 = self.tile_bounds(index)
            ox0, oy0 = max(gx0, tx0), max(gy0, ty0)
            ox1, oy1 = min(gx1, tx1), min(gy1, ty1)
            # output pixel d samples absolute position gx0 + d*reduce, taken
            # from the tile holding that position
            dx0 = max(-(-(ox0 - gx0) // reduce), 0)
            dy0 = max(-(-(oy0 - gy0) // reduce), 0)
            dx1 = min(-(-(ox1 - gx0) // reduce), out_w)
            dy1 = min(-(-(oy1 - gy0) // reduce), out_h)
            if dx1 <= dx0 or dy1 <= dy0:
                continue
            sx0 = (gx0 + dx0 * reduce - tx0) // reduce
            sy0 = (gy0 + dy0 * reduce - ty0) // reduce
            sw = min(dx1 - dx0, tile.shape[1] - sx0)
            sh = min(dy1 - dy0, tile.shape[0] - sy0)
            if sw <= 0 or sh <= 0:
                continue
            out[dy0 : dy0 + sh, dx0 : dx0 + sw] = tile[sy0 : sy0 + sh, sx0 : sx0 + sw]
        return out


def encode_tiled_j2k(image: np.ndarray, tile_size: int = 256, quality: int | None = None) -> bytes:
    """A multi-tile J2K codestream of an RGB or grey uint8 image, lossless
    (5/3, RCT, 5 levels, 64x64 code-blocks, one layer, LRCP), its tiles coded
    on threads.

    Raises:
        ValueError: ``tile_size`` is not a multiple of 64 (JAX's rule :337).
        NotImplementedError: a ``quality`` (lossy rate allocation is
            ``ROADMAP.md`` section 1's JPEG 2000 encoder item).
    """
    if tile_size % 64:
        msg = "tile_size must be a multiple of 64."
        raise ValueError(msg)
    if quality is not None:
        msg = (
            "encode_tiled_j2k(quality=...) needs OpenJPEG's rate allocation, which the port's "
            "encoder lacks (ROADMAP.md section 1, the JPEG 2000 encoder's quality= item); "
            "the port writes lossless streams."
        )
        raise NotImplementedError(msg)
    return native.encode_j2k(image, tile_size)


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_container(codestream: bytes, mpp: tuple[float, float] | None = None) -> bytes:
    """A JP2 file (ISO 15444-1 Annex I) holding ``codestream``: signature,
    file type, header (image header, sRGB or grey colour, and with ``mpp``
    a capture-resolution ``resc`` box in points per metre) and ``jp2c``."""
    info = native.j2k_header(codestream)
    grey = info["components"] == 1
    ihdr = struct.pack(">IIHBBBB", info["height"], info["width"], info["components"], 7, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 17 if grey else 16)
    header = _box(b"ihdr", ihdr) + _box(b"colr", colr)
    if mpp is not None:
        fields = []
        for um in (mpp[1], mpp[0]):  # vertical, then horizontal
            ppm = 1e6 / um
            exp = 0
            while round(ppm / 10.0**exp) > 0xFFFF:
                exp += 1
            fields.append((round(ppm / 10.0**exp), exp))
        (vn, ve), (hn, he) = fields
        header += _box(b"res ", _box(b"resc", struct.pack(">HHHHbb", vn, 1, hn, 1, ve, he)))
    return (
        _box(b"jP  ", b"\r\n\x87\n")
        + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
        + _box(b"jp2h", header)
        + _box(b"jp2c", codestream)
    )


def write_tiled_jp2(path: str | Path, image: np.ndarray, tile_size: int = 256, quality: int | None = None) -> Path:
    """Write a tiled raw-codestream ``.jp2`` file (JAX :374-384)."""
    path = Path(path)
    path.write_bytes(encode_tiled_j2k(image, tile_size, quality))
    return path
