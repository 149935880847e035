"""Minimal DICOM WSI parsing (counterpart of ``tiatoolbox_tpu/wsicore/dicom.py:1-533``).

The JAX module's parser, copied: file meta and explicit/implicit VR
little-endian datasets with nested sequences; TILED_FULL and TILED_SPARSE
frame organisations (sparse positions from the
PerFrameFunctionalGroupsSequence's PlanePositionSlideSequence, unoccupied
tiles white for colour slides and black for monochrome ones); concatenated
instances sharing a ConcatenationUID stitched into one level by
ConcatenationFrameOffsetNumber; native frames.

Encapsulated frames are decoded by the port's own codecs where JAX calls
``cv2.imdecode`` (:361-376): JPEG baseline and extended 8-bit
(``1.2.840.10008.1.2.4.50`` and ``.51``) through ``utils/imagecodec.py``,
JPEG 2000 (``.4.90`` lossless, ``.4.91``) through ``native.decode_j2k``,
the frames a region touches in one threaded batch. Every other
encapsulated transfer syntax raises ``FileNotSupportedError`` naming it,
HTJ2K (``.4.201``, ``.4.203``) among them. A non-empty Basic Offset Table
groups the fragments into frames; without one, each fragment is a frame as
in JAX, unless there are more fragments than frames: then a frame starts at
each fragment that opens with a JPEG SOI marker.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch.utils.exceptions import FileNotSupportedError
from tiatoolbox_tpu_torch.utils.imagecodec import imdecode

# transfer syntaxes
TS_IMPLICIT_LE = "1.2.840.10008.1.2"
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
_ENCAPSULATED_PREFIX = "1.2.840.10008.1.2.4"  # JPEG family / J2K
# encapsulated syntaxes the port's codec decodes
TS_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
TS_JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
TS_J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"
TS_J2K = "1.2.840.10008.1.2.4.91"
_J2K_SYNTAXES = (TS_J2K_LOSSLESS, TS_J2K)
_DECODED_SYNTAXES = (TS_JPEG_BASELINE, TS_JPEG_EXTENDED, *_J2K_SYNTAXES)
_SYNTAX_NAMES = {
    "1.2.840.10008.1.2.4.57": "JPEG lossless",
    "1.2.840.10008.1.2.4.70": "JPEG lossless, first-order prediction",
    "1.2.840.10008.1.2.4.80": "JPEG-LS lossless",
    "1.2.840.10008.1.2.4.81": "JPEG-LS near-lossless",
    "1.2.840.10008.1.2.4.201": "HTJ2K lossless (ROADMAP.md section 1)",
    "1.2.840.10008.1.2.4.203": "HTJ2K (ROADMAP.md section 1)",
    "1.2.840.10008.1.2.5": "RLE lossless",
}

# tags (group, element)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLUMNS = (0x0028, 0x0011)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_NUMBER_OF_FRAMES = (0x0028, 0x0008)
TAG_TOTAL_MATRIX_COLS = (0x0048, 0x0006)
TAG_TOTAL_MATRIX_ROWS = (0x0048, 0x0007)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_IMAGE_TYPE = (0x0008, 0x0008)
TAG_PHOTOMETRIC = (0x0028, 0x0004)
TAG_DIM_ORG_TYPE = (0x0020, 0x9311)
TAG_PER_FRAME_SEQ = (0x5200, 0x9230)
TAG_SHARED_FUNC_SEQ = (0x5200, 0x9229)
TAG_PLANE_POS_SEQ = (0x0048, 0x021A)  # PlanePositionSlideSequence
TAG_COL_POS = (0x0048, 0x021E)  # ColumnPositionInTotalImagePixelMatrix
TAG_ROW_POS = (0x0048, 0x021F)  # RowPositionInTotalImagePixelMatrix
TAG_CONCAT_UID = (0x0020, 0x9161)
TAG_CONCAT_OFFSET = (0x0020, 0x9228)  # ConcatenationFrameOffsetNumber
TAG_ITEM = (0xFFFE, 0xE000)
TAG_ITEM_END = (0xFFFE, 0xE00D)
TAG_SEQ_END = (0xFFFE, 0xE0DD)

_SHORT_VRS = {
    b"AE", b"AS", b"AT", b"CS", b"DA", b"DS", b"DT", b"FL", b"FD", b"IS",
    b"LO", b"LT", b"PN", b"SH", b"SL", b"SS", b"ST", b"TM", b"UI", b"UL",
    b"US",
}
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"UC", b"UR", b"OD", b"OL"}

# Implicit VR carries no VR bytes, so defined-length sequences are
# indistinguishable from binary values without a data dictionary; these
# are the sequence tags this parser must recurse into regardless.
_KNOWN_SQ_TAGS = {TAG_PER_FRAME_SEQ, TAG_SHARED_FUNC_SEQ, TAG_PLANE_POS_SEQ}

# Implicit VR also carries no type for binary integers. Every integer
# tag this parser consumes (except NumberOfFrames, which is IS = text)
# has a binary US/UL/SL VR in the standard — decode those at parse time
# so text-looking raw bytes (e.g. UL 48 = b"0\x00\x00\x00") can't be
# mistaken for ASCII digits later.
_KNOWN_INT_VRS = {
    TAG_ROWS: b"US",
    TAG_COLUMNS: b"US",
    TAG_SAMPLES_PER_PIXEL: b"US",
    TAG_TOTAL_MATRIX_COLS: b"UL",
    TAG_TOTAL_MATRIX_ROWS: b"UL",
    TAG_COL_POS: b"SL",
    TAG_ROW_POS: b"SL",
    TAG_CONCAT_OFFSET: b"UL",
}


@dataclass
class DicomDataset:
    """Flat tag→value mapping plus raw frame access."""

    elements: dict = field(default_factory=dict)
    frames: list = field(default_factory=list)
    transfer_syntax: str = TS_EXPLICIT_LE
    # TILED_SPARSE: per-frame (row_px, col_px) 1-based positions in the
    # total pixel matrix, parsed from PerFrameFunctionalGroupsSequence
    frame_positions: list = field(default_factory=list)

    def get(self, tag, default=None):
        return self.elements.get(tag, default)

    def get_int(self, tag, default=0) -> int:
        value = self.elements.get(tag)
        if value is None:
            return default
        raw = value
        if isinstance(value, bytes):
            value = value.decode("latin-1").strip("\x00 ").strip()
        try:
            return int(float(value))
        except (TypeError, ValueError):
            # implicit VR stores US/UL/SL values as raw little-endian
            # bytes (no VR to decode them at parse time)
            if isinstance(raw, bytes) and len(raw) == 4:
                return struct.unpack("<i", raw)[0]
            if isinstance(raw, bytes) and len(raw) == 2:
                return struct.unpack("<H", raw)[0]
            return default

    def get_str(self, tag, default="") -> str:
        value = self.elements.get(tag)
        if value is None:
            return default
        if isinstance(value, bytes):
            return value.decode("latin-1").strip("\x00 ").strip()
        return str(value)


def _parse_elements(  # noqa: C901, PLR0912
    data: bytes,
    offset: int,
    end: int,
    ds: DicomDataset,
    *,
    explicit: bool,
    capture_pixels: bool,
) -> int:
    """Parse data elements in [offset, end); returns the final offset."""
    while offset + 8 <= end:
        group, element = struct.unpack_from("<HH", data, offset)
        tag = (group, element)
        offset += 4
        if tag in (TAG_ITEM_END, TAG_SEQ_END):
            offset += 4
            return offset
        if tag == TAG_ITEM:
            (length,) = struct.unpack_from("<I", data, offset)
            offset += 4
            item_end = offset + length if length != 0xFFFFFFFF else end
            offset = _parse_elements(
                data, offset, item_end, ds, explicit=explicit, capture_pixels=capture_pixels
            )
            continue
        if explicit and group != 0xFFFE:
            vr = data[offset : offset + 2]
            if vr in _LONG_VRS:
                (length,) = struct.unpack_from("<I", data, offset + 4)
                offset += 8
            elif vr in _SHORT_VRS or vr.isalpha():
                (length,) = struct.unpack_from("<H", data, offset + 2)
                offset += 4
            else:  # not a VR → implicit fallback
                vr = b"UN"
                (length,) = struct.unpack_from("<I", data, offset)
                offset += 4
        else:
            vr = b"UN"
            (length,) = struct.unpack_from("<I", data, offset)
            offset += 4

        if tag == TAG_PIXEL_DATA:
            if length == 0xFFFFFFFF:  # encapsulated
                offset = _parse_encapsulated_frames(data, offset, ds)
            else:
                if capture_pixels:
                    ds.frames = [data[offset : offset + length]]
                    ds.elements[tag] = b""  # marker
                offset += length
            continue

        if length == 0xFFFFFFFF or vr == b"SQ" or (
            vr == b"UN" and tag in _KNOWN_SQ_TAGS
        ):
            seq_end = offset + length if length != 0xFFFFFFFF else end
            if tag == TAG_PER_FRAME_SEQ:
                offset = _parse_per_frame_sequence(
                    data, offset, seq_end, ds,
                    explicit=explicit,
                    undefined=length == 0xFFFFFFFF,
                )
                continue
            offset = _parse_sequence(
                data, offset, seq_end, ds,
                explicit=explicit,
                undefined=length == 0xFFFFFFFF,
            )
            continue

        value = data[offset : offset + length]
        offset += length
        if vr == b"UN":
            vr = _KNOWN_INT_VRS.get(tag, vr)
        if vr == b"US" and length == 2:
            ds.elements[tag] = struct.unpack("<H", value)[0]
        elif vr == b"UL" and length == 4:
            ds.elements[tag] = struct.unpack("<I", value)[0]
        elif vr == b"SL" and length == 4:
            ds.elements[tag] = struct.unpack("<i", value)[0]
        elif tag not in ds.elements:  # first (outermost/shared) value wins
            ds.elements[tag] = value
    return offset


def _parse_sequence(
    data: bytes, offset: int, end: int, ds: DicomDataset, *, explicit: bool, undefined: bool
) -> int:
    """Walk a sequence, recursing into items (flattening nested tags)."""
    while offset + 8 <= end:
        group, element = struct.unpack_from("<HH", data, offset)
        if (group, element) == TAG_SEQ_END:
            return offset + 8
        if (group, element) == TAG_ITEM:
            (length,) = struct.unpack_from("<I", data, offset + 4)
            offset += 8
            item_end = offset + length if length != 0xFFFFFFFF else end
            offset = _parse_elements(
                data, offset, item_end, ds, explicit=explicit, capture_pixels=False
            )
        else:
            break
        if not undefined and offset >= end:
            return end
    return offset if undefined else end


def _parse_per_frame_sequence(
    data: bytes, offset: int, end: int, ds: DicomDataset, *, explicit: bool, undefined: bool
) -> int:
    """Walk PerFrameFunctionalGroupsSequence: one position per item.

    Each frame item nests a PlanePositionSlideSequence carrying the
    frame's 1-based (row, col) pixel position in the total matrix
    (wsidicom semantics for TILED_SPARSE; reference consumes them via
    wsidicom in ``wsireader.py:5191-5724``).
    """
    while offset + 8 <= end:
        group, element = struct.unpack_from("<HH", data, offset)
        if (group, element) == TAG_SEQ_END:
            return offset + 8
        if (group, element) != TAG_ITEM:
            break
        (length,) = struct.unpack_from("<I", data, offset + 4)
        offset += 8
        item_end = offset + length if length != 0xFFFFFFFF else end
        item_ds = DicomDataset()
        offset = _parse_elements(
            data, offset, item_end, item_ds,
            explicit=explicit, capture_pixels=False,
        )
        row = item_ds.get_int(TAG_ROW_POS, 0)
        col = item_ds.get_int(TAG_COL_POS, 0)
        ds.frame_positions.append((row, col))
        if not undefined and offset >= end:
            return end
    return offset if undefined else end


def _parse_encapsulated_frames(data: bytes, offset: int, ds: DicomDataset) -> int:
    """Collect encapsulated PixelData fragments into frames."""
    fragments = []
    while offset + 8 <= len(data):
        group, element = struct.unpack_from("<HH", data, offset)
        (length,) = struct.unpack_from("<I", data, offset + 4)
        offset += 8
        if (group, element) == TAG_SEQ_END:
            break
        fragments.append(data[offset : offset + length])
        offset += length
    if fragments:
        # first item is the Basic Offset Table: the offset of each frame's
        # first fragment, counted from the first fragment's item tag
        bot = fragments[0]
        frames = fragments[1:]
        if len(bot) >= 4 and len(bot) // 4 != len(frames):
            starts = list(struct.unpack(f"<{len(bot) // 4}I", bot[: len(bot) // 4 * 4]))
            grouped, pos, current = [], 0, None
            for fragment in frames:
                if pos in starts:
                    current = bytearray()
                    grouped.append(current)
                if current is not None:
                    current += fragment
                pos += 8 + len(fragment)
            frames = [bytes(f) for f in grouped]
        elif not bot and len(frames) > ds.get_int(TAG_NUMBER_OF_FRAMES, len(frames)):
            # no offset table and more fragments than frames: a JPEG frame
            # starts at each fragment that opens with an SOI marker
            grouped = []
            for fragment in frames:
                if fragment[:2] == b"\xff\xd8" or not grouped:
                    grouped.append(bytearray())
                grouped[-1] += fragment
            frames = [bytes(f) for f in grouped]
        ds.frames = frames
    return offset


class DicomFile:
    """One parsed WSI DICOM instance (one pyramid level)."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        data = self.path.read_bytes()
        if data[128:132] != b"DICM":
            msg = f"Not a DICOM file: {path}"
            raise ValueError(msg)
        self.ds = DicomDataset()
        # file meta group is always explicit VR LE
        offset = 132
        meta_ds = DicomDataset()
        # parse group 0002 elements until group changes
        while offset + 8 <= len(data):
            group = struct.unpack_from("<H", data, offset)[0]
            if group != 0x0002:
                break
            offset = self._parse_one_meta(data, offset, meta_ds)
        self.transfer_syntax = meta_ds.get_str(TAG_TRANSFER_SYNTAX, TS_EXPLICIT_LE)
        explicit = self.transfer_syntax != TS_IMPLICIT_LE
        _parse_elements(
            data, offset, len(data), self.ds, explicit=explicit, capture_pixels=True
        )
        self.ds.transfer_syntax = self.transfer_syntax

    @staticmethod
    def _parse_one_meta(data: bytes, offset: int, ds: DicomDataset) -> int:
        group, element = struct.unpack_from("<HH", data, offset)
        vr = data[offset + 4 : offset + 6]
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from("<I", data, offset + 8)
            value_off = offset + 12
        else:
            (length,) = struct.unpack_from("<H", data, offset + 6)
            value_off = offset + 8
        ds.elements[(group, element)] = data[value_off : value_off + length]
        return value_off + length

    # -- geometry ----------------------------------------------------------------

    @property
    def frame_shape(self) -> tuple[int, int]:
        return (self.ds.get_int(TAG_ROWS), self.ds.get_int(TAG_COLUMNS))

    @property
    def total_shape(self) -> tuple[int, int]:
        rows = self.ds.get_int(TAG_TOTAL_MATRIX_ROWS) or self.frame_shape[0]
        cols = self.ds.get_int(TAG_TOTAL_MATRIX_COLS) or self.frame_shape[1]
        return (rows, cols)

    @property
    def n_frames(self) -> int:
        return self.ds.get_int(TAG_NUMBER_OF_FRAMES, 1)

    @property
    def mpp(self) -> tuple[float, float] | None:
        spacing = self.ds.get_str(TAG_PIXEL_SPACING)
        if not spacing:
            return None
        parts = spacing.replace("\\\\", "\\").split("\\")
        if len(parts) != 2:
            return None
        try:
            row_mm, col_mm = float(parts[0]), float(parts[1])
        except ValueError:
            return None
        return (col_mm * 1000.0, row_mm * 1000.0)

    def decode_frame(self, index: int) -> np.ndarray:
        """Decode frame ``index`` to an HxWxC uint8 array."""
        rows, cols = self.frame_shape
        spp = self.ds.get_int(TAG_SAMPLES_PER_PIXEL, 3)
        syntax = self.transfer_syntax
        if syntax in _SYNTAX_NAMES or (
            syntax.startswith(_ENCAPSULATED_PREFIX) and syntax not in _DECODED_SYNTAXES
        ):
            name = _SYNTAX_NAMES.get(syntax, "this encapsulated syntax")
            msg = f"DICOM transfer syntax {syntax} ({name}) is not decoded by the port."
            raise FileNotSupportedError(msg)
        if syntax in _J2K_SYNTAXES:
            return self.decode_frames([index])[0]
        if syntax in _DECODED_SYNTAXES:
            arr = imdecode(self.frames_at(index), "unchanged")
            if arr is None:
                msg = f"Could not decode DICOM frame {index}."
                raise ValueError(msg)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            return arr
        # native pixel data: one blob holding all frames
        blob = self.ds_frames_native()
        frame_bytes = rows * cols * spp
        start = index * frame_bytes
        frame = np.frombuffer(blob[start : start + frame_bytes], np.uint8)
        return frame.reshape(rows, cols, spp)

    def decode_frames(self, indices: list[int]) -> list[np.ndarray]:
        """Decode frames ``indices``; JPEG 2000 frames in one threaded batch."""
        if self.transfer_syntax not in _J2K_SYNTAXES:
            return [self.decode_frame(i) for i in indices]
        from tiatoolbox_tpu_torch import native

        try:
            return native.decode_j2k_batch([self.frames_at(i) for i in indices])
        except native.J2kDecodeError as exc:
            msg = f"Could not decode DICOM frame {indices[exc.index]}: {exc}"
            raise ValueError(msg) from exc

    def frames_at(self, index: int) -> bytes:
        return self.ds.frames[index]

    def ds_frames_native(self) -> bytes:
        return self.ds.frames[0]

    # -- organisation / concatenation ------------------------------------------

    @property
    def photometric(self) -> str:
        return self.ds.get_str(TAG_PHOTOMETRIC, "RGB").upper()

    @property
    def is_sparse(self) -> bool:
        """TILED_SPARSE: explicit per-frame positions govern placement.

        Per the standard, organisation defaults to sparse when
        DimensionOrganizationType is absent but per-frame positions are
        present and don't cover the full row-major grid.
        """
        org = self.ds.get_str(TAG_DIM_ORG_TYPE).upper()
        if org == "TILED_FULL":
            return False
        return bool(self.ds.frame_positions)

    @property
    def concatenation_uid(self) -> str:
        return self.ds.get_str(TAG_CONCAT_UID, "")

    @property
    def concatenation_offset(self) -> int:
        return self.ds.get_int(TAG_CONCAT_OFFSET, 0)


class _DicomLevel:
    """One pyramid level: a single instance or a concatenation group.

    Presents a uniform frame-grid API to ``DicomSlide.read_region``:
    ``frame_for_cell(fy, fx)`` resolves a grid cell to a decodable
    (instance, local_frame_index) pair — via the row-major rule for
    TILED_FULL, or the merged sparse frame map for TILED_SPARSE —
    or None for unoccupied (background) cells.
    """

    def __init__(self, parts: list[DicomFile]) -> None:
        parts = sorted(parts, key=lambda p: p.concatenation_offset)
        self.parts = parts
        head = parts[0]
        self.frame_shape = head.frame_shape
        self.total_shape = head.total_shape
        self.mpp = head.mpp
        self.spp = head.ds.get_int(TAG_SAMPLES_PER_PIXEL, 3)
        # brightfield colour slides read white where no tile exists
        self.fill_value = 0 if "MONOCHROME" in head.photometric else 255
        rows, cols = self.frame_shape
        self._cells: dict[tuple[int, int], tuple[DicomFile, int]] = {}
        sparse = any(p.is_sparse for p in parts)
        frames_across = -(-self.total_shape[1] // cols)
        for part in parts:
            if sparse and part.ds.frame_positions:
                for local_idx, (row_px, col_px) in enumerate(
                    part.ds.frame_positions
                ):
                    cell = ((row_px - 1) // rows, (col_px - 1) // cols)
                    self._cells[cell] = (part, local_idx)
            else:
                # row-major rule; also the fallback for a part without
                # per-frame positions inside a sparse group (its frames
                # would otherwise silently vanish into background fill)
                offset = part.concatenation_offset
                for local_idx in range(part.n_frames):
                    global_idx = offset + local_idx
                    cell = (global_idx // frames_across, global_idx % frames_across)
                    self._cells[cell] = (part, local_idx)

    @property
    def n_frames(self) -> int:
        return sum(p.n_frames for p in self.parts)

    def frame_for_cell(self, fy: int, fx: int):
        return self._cells.get((fy, fx))


class DicomSlide:
    """A pyramid of DICOM instances (a directory, series, or one file)."""

    def __init__(self, path: str | Path) -> None:
        path = Path(path)
        paths = (
            sorted(path.glob("*.dcm")) if path.is_dir() else [path]
        )
        if not paths:
            msg = f"No DICOM instances found at {path}"
            raise ValueError(msg)
        instances = [DicomFile(p) for p in paths]
        # keep VOLUME images (drop LABEL/OVERVIEW) when type info present
        volumes = [
            inst
            for inst in instances
            if "LABEL" not in inst.ds.get_str(TAG_IMAGE_TYPE)
            and "OVERVIEW" not in inst.ds.get_str(TAG_IMAGE_TYPE)
        ] or instances
        # group concatenated instances (shared ConcatenationUID) into
        # one level; standalone instances form their own level
        groups: dict[str, list[DicomFile]] = {}
        for inst in volumes:
            key = inst.concatenation_uid or f"__solo_{id(inst)}"
            groups.setdefault(key, []).append(inst)
        levels = [_DicomLevel(parts) for parts in groups.values()]
        levels.sort(key=lambda lv: -lv.total_shape[1])
        self.levels = levels

    def read_region(self, level: int, location, size) -> np.ndarray:
        """Read (x, y, w, h) from a level, assembling tile frames.

        TILED_FULL levels place frames row-major; TILED_SPARSE levels
        use the per-frame position map and fill unoccupied cells with
        the background value (white for colour, black for monochrome).
        """
        lv = self.levels[level]
        rows, cols = lv.frame_shape
        total_rows, total_cols = lv.total_shape
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        spp = lv.spp
        out = np.full((h, w, spp), lv.fill_value, np.uint8)
        # out-of-matrix padding stays zero (reader pad semantics)
        pad_mask = np.ones((h, w), bool)
        ix0, iy0 = max(x0, 0), max(y0, 0)
        ix1 = min(x0 + w, total_cols)
        iy1 = min(y0 + h, total_rows)
        if ix1 <= ix0 or iy1 <= iy0:
            return np.zeros((h, w, spp), np.uint8)
        pad_mask[iy0 - y0 : iy1 - y0, ix0 - x0 : ix1 - x0] = False
        out[pad_mask] = 0
        cells = []
        for fy in range(iy0 // rows, (iy1 - 1) // rows + 1):
            for fx in range(ix0 // cols, (ix1 - 1) // cols + 1):
                hit = lv.frame_for_cell(fy, fx)
                if hit is not None:  # else a sparse background cell
                    cells.append((fy, fx, *hit))
        wanted: dict[int, tuple[DicomFile, list[int]]] = {}  # each part's frames, decoded together
        for _fy, _fx, part, local_idx in cells:
            wanted.setdefault(id(part), (part, []))[1].append(local_idx)
        frames = {}
        for key, (part, indices) in wanted.items():
            frames.update({(key, i): f for i, f in zip(indices, part.decode_frames(indices))})
        for fy, fx, part, local_idx in cells:
            frame = frames[(id(part), local_idx)]
            fx0, fy0 = fx * cols, fy * rows
            sx0, sy0 = max(ix0 - fx0, 0), max(iy0 - fy0, 0)
            sx1 = min(ix1 - fx0, cols)
            sy1 = min(iy1 - fy0, rows)
            out[
                fy0 + sy0 - y0 : fy0 + sy1 - y0,
                fx0 + sx0 - x0 : fx0 + sx1 - x0,
            ] = frame[sy0:sy1, sx0:sx1]
        return out
