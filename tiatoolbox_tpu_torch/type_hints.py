"""Shared type aliases (counterpart of ``tiatoolbox_tpu/type_hints.py:1-45``).

Copied; the geometry aliases bind to the port's own geometry library
(``tiatoolbox_tpu_torch/annotation/geometry.py``) instead of Shapely.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Literal, SupportsFloat, Union

import numpy as np

from tiatoolbox_tpu_torch.annotation.geometry import LineString, Point, Polygon

JSON = Union[dict, list, str, int, float, bool, None]
NumPair = tuple[SupportsFloat, SupportsFloat]
IntPair = tuple[int, int]

Resolution = Union[SupportsFloat, NumPair, np.ndarray, Sequence[SupportsFloat]]
Units = Literal["mpp", "power", "baseline", "level"]
Bounds = tuple[SupportsFloat, SupportsFloat, SupportsFloat, SupportsFloat]
IntBounds = tuple[int, int, int, int]

Geometry = Union[Point, LineString, Polygon]
Properties = JSON
QueryGeometry = Union[Bounds, Geometry]
CallablePredicate = Callable[[dict], bool]
CallableSelect = Callable[[dict], dict]
Predicate = Union[str, bytes, CallablePredicate]
Select = Union[str, bytes, CallableSelect]

NumpyPadLiteral = Literal[
    "constant",
    "edge",
    "linear_ramp",
    "maximum",
    "mean",
    "median",
    "minimum",
    "reflect",
    "symmetric",
    "wrap",
    "empty",
]
