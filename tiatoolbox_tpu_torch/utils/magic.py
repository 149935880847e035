"""File-type sniffing from leading bytes (counterpart of ``tiatoolbox_tpu/utils/magic.py:1-81``).

``is_sqlite3`` (with which ``AnnotationStore.open`` tells an SQLite store from
a GeoJSON file) and the sniffers of ``WSIReader.open``'s dispatch: ``is_zip``,
``is_dcm``, ``is_tiff``, ``is_jp2``, ``is_png``, ``is_jpeg``, ``is_dir``,
``is_zarr`` and ``is_ngff``, copied.
"""

from __future__ import annotations

from pathlib import Path


def _read_head(path, n: int = 256) -> bytes:
    path = Path(path)
    if not path.is_file():
        return b""
    with path.open("rb") as fh:
        return fh.read(n)


def is_sqlite3(path) -> bool:
    """True if the file is an SQLite 3 database."""
    return _read_head(path, 16).startswith(b"SQLite format 3\x00")


def is_zip(path) -> bool:
    """True if the file is a ZIP archive."""
    return _read_head(path, 4) in (b"PK\x03\x04", b"PK\x05\x06", b"PK\x07\x08")


def is_dcm(path) -> bool:
    """True if the file is a DICOM file (DICM magic at offset 128)."""
    head = _read_head(path, 132)
    return len(head) >= 132 and head[128:132] == b"DICM"


def is_tiff(path) -> bool:
    """True if the file is a little/big-endian classic or BigTIFF."""
    head = _read_head(path, 4)
    return head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def is_jp2(path) -> bool:
    """True for a JPEG-2000 JP2 container or raw J2K codestream."""
    head = _read_head(path, 12)
    return head[4:12] == b"jP  \r\n\x87\n" or head[:4] == b"\xff\x4f\xff\x51"


def is_png(path) -> bool:
    """True if the file is a PNG."""
    return _read_head(path, 8) == b"\x89PNG\r\n\x1a\n"


def is_jpeg(path) -> bool:
    """True if the file is a JFIF/raw JPEG."""
    return _read_head(path, 2) == b"\xff\xd8"


def is_dir(path) -> bool:
    """True if the path is a directory."""
    return Path(path).is_dir()


def is_zarr(path) -> bool:
    """True if the path looks like a zarr array/group directory."""
    p = Path(path)
    return p.is_dir() and (
        (p / ".zarray").exists() or (p / ".zgroup").exists() or (p / "zarr.json").exists()
    )


def is_ngff(path) -> bool:
    """True if the path looks like an OME-NGFF zarr group."""
    p = Path(path)
    if not p.is_dir():
        return False
    zattrs = p / ".zattrs"
    if not zattrs.exists():
        return False
    try:
        import json

        attrs = json.loads(zattrs.read_text())
    except (OSError, ValueError):
        return False
    return "multiscales" in attrs
