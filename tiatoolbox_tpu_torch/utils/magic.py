"""File-type sniffing from leading bytes (counterpart of ``tiatoolbox_tpu/utils/magic.py:1-19``).

Only what the annotation store needs: ``is_sqlite3``, with which
``AnnotationStore.open`` tells an SQLite store from a GeoJSON file.
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
