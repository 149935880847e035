"""The port's host C++, loaded with ctypes (counterpart of ``tiatoolbox_tpu/native/__init__.py``).

``csrc/watershed.cpp`` is built with ``g++`` by ``_build.py`` into
``build_torch/`` at first use; a failed build raises, and there is no
Python fallback on the path. It holds:

- ``watershed`` (JAX :131-156): the marker watershed of
  ``skimage.segmentation.watershed(image, markers, mask=mask)``, the image
  cast to float32 as JAX's wrapper casts it;
- ``outer_contours``: the outer border of each instance of a label map,
  as ``cv2.findContours(RETR_TREE, CHAIN_APPROX_SIMPLE)[0][0]`` gives it on
  the instance's crop (``hovernet.py:555-558``).

The JPEG and LZW decoders of the JAX module are not ported yet
(ROADMAP item 2).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tiatoolbox_tpu_torch import _build

SOURCE = "watershed.cpp"


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
