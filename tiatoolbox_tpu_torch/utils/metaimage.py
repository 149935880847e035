"""MetaImage (``.mha``) files and registration transforms (counterpart of
``tiatoolbox_tpu/utils/metaimage.py``).

``read_mha`` (:63), ``write_mha`` (:115) and ``load_transform`` (:179) are
JAX's, copied as they are: a single-file ("LOCAL") MetaImage is an ASCII
``Key = Value`` header ending in ``ElementDataFile = LOCAL`` and the raw,
optionally zlib-compressed, pixels, x fastest. Arrays are channels-last,
``(H, W)`` or ``(H, W, C)`` in 2-D; the files written are JAX's byte for
byte. ``load_transform`` returns the two forms ``TransformedWSIReader``
takes: a 3x3 affine or an ``(H, W, 2)`` displacement field.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

_MET_DTYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v).name: k for k, v in _MET_DTYPES.items()}


def _parse_header(raw: bytes) -> tuple[dict, int]:
    """Parse the ASCII header; return (fields, data offset)."""
    fields: dict[str, str] = {}
    pos = 0
    while True:
        nl = raw.find(b"\n", pos)
        if nl < 0:
            msg = "Truncated MetaImage header (no ElementDataFile line)."
            raise ValueError(msg)
        line = raw[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if not line:
            continue
        key, sep, value = line.partition("=")
        if not sep:
            msg = f"Malformed MetaImage header line: {line!r}"
            raise ValueError(msg)
        key = key.strip()
        fields[key] = value.strip()
        if key == "ElementDataFile":
            return fields, pos


def read_mha(path: str | Path) -> np.ndarray:
    """Read a single-file MetaImage into a channels-last ndarray."""
    raw = Path(path).read_bytes()
    fields, offset = _parse_header(raw)
    if fields.get("ObjectType", "Image") != "Image":
        msg = f"Unsupported MetaImage ObjectType: {fields['ObjectType']}"
        raise ValueError(msg)
    if fields["ElementDataFile"] != "LOCAL":
        msg = "Only single-file (ElementDataFile = LOCAL) .mha is supported."
        raise ValueError(msg)
    try:
        dtype = np.dtype(_MET_DTYPES[fields["ElementType"]])
    except KeyError as exc:
        msg = f"Unsupported MetaImage ElementType: {fields.get('ElementType')}"
        raise ValueError(msg) from exc
    dims = [int(v) for v in fields["DimSize"].split()]
    channels = int(fields.get("ElementNumberOfChannels", "1"))
    if fields.get("BinaryData", "True").lower() != "true":
        msg = "ASCII MetaImage data is not supported."
        raise ValueError(msg)
    payload = raw[offset:]
    if fields.get("CompressedData", "False").lower() == "true":
        declared = fields.get("CompressedDataSize")
        if declared is not None and len(payload) < int(declared):
            msg = (
                f"MetaImage data corrupt/truncated: CompressedDataSize "
                f"declares {declared} bytes, have {len(payload)}."
            )
            raise ValueError(msg)
        try:
            payload = zlib.decompress(payload)
        except zlib.error as exc:
            msg = f"MetaImage data corrupt/truncated: {exc}"
            raise ValueError(msg) from exc
    count = int(np.prod(dims)) * channels
    if len(payload) < count * dtype.itemsize:
        msg = (
            f"MetaImage data truncated: need {count * dtype.itemsize} bytes, "
            f"have {len(payload)}."
        )
        raise ValueError(msg)
    read_dtype = (
        dtype.newbyteorder(">")
        if fields.get("BinaryDataByteOrderMSB", "False").lower() == "true"
        else dtype
    )
    data = np.frombuffer(payload, dtype=read_dtype, count=count).astype(dtype)
    # MetaImage stores x-fastest: reshape to (..., y, x, c) reversed dims.
    shape = tuple(reversed(dims)) + ((channels,) if channels > 1 else ())
    return np.ascontiguousarray(data.reshape(shape))


def write_mha(
    path: str | Path,
    array: np.ndarray,
    *,
    spacing: tuple | None = None,
    compressed: bool = False,
    vector: bool | None = None,
) -> Path:
    """Write a channels-last ndarray as a single-file MetaImage.

    ``vector`` forces (or forbids, with ``False``) treating the last
    axis as the channel axis. By default only a 3-D array whose
    trailing axis is 2 or 3 is auto-detected as a 2-D vector image
    (displacement fields ``(H, W, 2)``, RGB ``(H, W, 3)``); any other
    ≥3-D shape with a small trailing axis is ambiguous (it could be a
    3-D scalar volume) and requires an explicit ``vector`` argument.
    """
    array = np.asarray(array)
    if vector is None:
        if array.ndim == 3 and array.shape[-1] in (2, 3):
            vector = True
        elif array.ndim >= 4 and array.shape[-1] <= 4:
            msg = (
                f"Ambiguous shape {array.shape}: pass vector=True to store "
                "the last axis as channels, or vector=False for a scalar "
                "volume."
            )
            raise ValueError(msg)
        else:
            vector = False
    channels = array.shape[-1] if vector else 1
    spatial = array.shape[:-1] if vector else array.shape
    dims = " ".join(str(d) for d in reversed(spatial))
    try:
        met_type = _MET_NAMES[array.dtype.name]
    except KeyError as exc:
        msg = f"No MetaImage element type for dtype {array.dtype}"
        raise ValueError(msg) from exc
    spacing = spacing or (1.0,) * len(spatial)
    payload = np.ascontiguousarray(array).tobytes()
    lines = [
        "ObjectType = Image",
        f"NDims = {len(spatial)}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        payload = zlib.compress(payload)
        lines.append(f"CompressedDataSize = {len(payload)}")
    lines += [
        f"ElementSpacing = {' '.join(str(float(s)) for s in reversed(spacing))}",
        f"DimSize = {dims}",
    ]
    if channels > 1:
        lines.append(f"ElementNumberOfChannels = {channels}")
    lines += [f"ElementType = {met_type}", "ElementDataFile = LOCAL"]
    path = Path(path)
    with path.open("wb") as fh:
        fh.write(("\n".join(lines) + "\n").encode("ascii"))
        fh.write(payload)
    return path


def load_transform(path: str | Path) -> np.ndarray:
    """Load a registration transform from ``.npy`` or ``.mha``.

    Returns either a 3x3 affine or an ``(H, W, 2)`` displacement field
    — the two forms ``TransformedWSIReader`` accepts.
    """
    path = Path(path)
    if path.suffix.lower() == ".npy":
        arr = np.load(path)
    elif path.suffix.lower() == ".mha":
        arr = read_mha(path)
    else:
        msg = f"Unsupported transform file type: {path.suffix}"
        raise ValueError(msg)
    arr = np.asarray(arr, dtype=float)
    if arr.shape == (3, 3) or (arr.ndim == 3 and arr.shape[-1] == 2):
        return arr
    if arr.shape == (2, 3):  # affine without the homogeneous row
        return np.vstack([arr, [0.0, 0.0, 1.0]])
    msg = (
        f"Transform in {path.name} has shape {arr.shape}; expected a 3x3 "
        "affine, a (2, 3) affine, or an (H, W, 2) displacement field."
    )
    raise ValueError(msg)
