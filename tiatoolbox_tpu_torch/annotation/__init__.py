"""Spatially indexed annotation storage (counterpart of ``tiatoolbox_tpu/annotation/__init__.py``).

Geometry comes from the port's ``geometry`` module (WKB/WKT/GeoJSON codecs
and predicates) instead of Shapely, and the SQLite backend uses the
standard library's sqlite3 with its compiled-in R*Tree module.
"""

from tiatoolbox_tpu_torch.annotation.storage import (  # noqa: F401
    Annotation,
    AnnotationStore,
    DictionaryStore,
    SQLiteStore,
)
