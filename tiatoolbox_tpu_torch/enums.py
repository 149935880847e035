"""Enumerated types (counterpart of ``tiatoolbox_tpu/enums.py:1-56``).

``GeometryType`` values are the WKB geometry type codes, so they cast
directly to and from the codec in ``annotation/geometry.py``. Accepts the
integer code or the GeoJSON-style name (``GeometryType("MultiPolygon")``).
"""

from __future__ import annotations

import enum
import re


class GeometryType(enum.IntEnum):
    """Kinds of geometry, keyed by WKB type code.

    Initialize with an integer or string representation:
        1 or "Point" -> POINT
        2 or "LineString" -> LINE_STRING
        3 or "Polygon" -> POLYGON
        4 or "MultiPoint" -> MULTI_POINT
        5 or "MultiLineString" -> MULTI_LINE_STRING
        6 or "MultiPolygon" -> MULTI_POLYGON
        7 or "GeometryCollection" -> GEOMETRY_COLLECTION
    """

    POINT = 1
    LINE_STRING = 2
    POLYGON = 3
    MULTI_POINT = 4
    MULTI_LINE_STRING = 5
    MULTI_POLYGON = 6
    GEOMETRY_COLLECTION = 7

    def __str__(self) -> str:
        """Space-separated title form, e.g. ``"Multi Polygon"``.

        (Reference behaviour — for the GeoJSON/WKT name use
        :attr:`camel_name`.)
        """
        return self.name.title().replace("_", " ")

    @property
    def camel_name(self) -> str:
        """GeoJSON-style UpperCamelCase name, e.g. ``"MultiPolygon"``."""
        return self.name.title().replace("_", "")

    @classmethod
    def _missing_(cls, value: object) -> object:
        if isinstance(value, str):
            # UpperCamelCase -> UPPER_CAMEL_CASE member lookup
            name = re.sub(r"(?<!^)(?=[A-Z])", "_", value).upper()
            if name in cls.__members__:
                return cls[name]
        return super()._missing_(value)
