"""The port's rasteriser (``csrc/raster.cpp``), box blur and colour maps against cv2.

Tolerance: none. Every primitive is held to cv2 bit for bit over
hypothesis-drawn cases (derandomised, so each run draws the same ones):
coordinates on, off and far off the canvas, thicknesses 1-5, radii 1-12,
3- and 4-channel canvases.

- ``fill_poly`` as ``cv2.fillPoly``, one contour or a shell with a hole
  filled in ``(0, 0, 0, 0)`` after it, as ``AnnotationRenderer`` draws;
- ``polylines`` as ``cv2.polylines``, open and closed, and as
  ``cv2.drawContours(img, [c], -1, color, t)``;
- ``line`` as ``cv2.line``, ``circle`` as ``cv2.circle(..., -1)``;
- ``box_blur`` as ``cv2.blur`` for every size from 1 to 40;
- ``apply_color_map`` as ``cv2.applyColorMap`` followed by BGR to RGB;
- ``colormap_rgba`` as ``matplotlib.colormaps[name](x)``.

The golden set the smoke checks on the card machine
(``data/raster_golden.npz``) is what ``scripts/make_raster_golden.py`` writes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import cv2
import matplotlib
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.utils import visualization as port_vis

ROOT = Path(__file__).resolve().parents[1]


@st.composite
def scenes(draw, max_points: int = 12):
    """A canvas, points that may lie off it, a colour, thickness and radius."""
    h = draw(st.integers(4, 80))
    w = draw(st.integers(4, 80))
    cn = draw(st.sampled_from([3, 4]))
    span = draw(st.sampled_from([1, 2, 20]))
    n = draw(st.integers(1, max_points))
    coord = st.integers(-span * max(h, w), span * max(h, w) + max(h, w))
    pts = np.array([[draw(coord), draw(coord)] for _ in range(n)], np.int32)
    color = tuple(draw(st.integers(0, 255)) for _ in range(4))
    thickness = draw(st.integers(1, 5))
    radius = draw(st.integers(1, 12))
    return np.zeros((h, w, cn), np.uint8), pts, color, thickness, radius


SETTINGS = settings(max_examples=400, deadline=None, derandomize=True)


@SETTINGS
@given(scenes())
def test_fill_poly_as_cv2(scene) -> None:
    canvas, pts, color, _, _ = scene
    want = cv2.fillPoly(canvas.copy(), [pts.reshape(-1, 1, 2)], color)
    got = native.fill_poly(canvas.copy(), [pts], color)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(scenes(), scenes())
def test_fill_poly_with_hole_as_cv2(scene, hole_scene) -> None:
    canvas, pts, color, thickness, _ = scene
    hole = hole_scene[1]
    want = canvas.copy()
    cv2.fillPoly(want, [pts.reshape(-1, 1, 2)], color)
    cv2.fillPoly(want, [hole.reshape(-1, 1, 2)], (0, 0, 0, 0))
    cv2.polylines(want, [pts.reshape(-1, 1, 2)], True, (0, 0, 0, 255), thickness)
    got = canvas.copy()
    native.fill_poly(got, [pts], color)
    native.fill_poly(got, [hole], (0, 0, 0, 0))
    native.polylines(got, [pts], True, (0, 0, 0, 255), thickness)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(scenes(), scenes(max_points=6))
def test_fill_poly_many_contours_as_cv2(scene, other) -> None:
    canvas, pts, color, _, _ = scene
    want = cv2.fillPoly(canvas.copy(), [pts.reshape(-1, 1, 2), other[1].reshape(-1, 1, 2)], color)
    got = native.fill_poly(canvas.copy(), [pts, other[1]], color)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("closed", [False, True])
@SETTINGS
@given(scene=scenes())
def test_polylines_as_cv2(closed: bool, scene) -> None:
    canvas, pts, color, thickness, _ = scene
    want = cv2.polylines(canvas.copy(), [pts.reshape(-1, 1, 2)], closed, color, thickness)
    got = native.polylines(canvas.copy(), [pts], closed, color, thickness)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(scenes())
def test_draw_contours_is_closed_polylines(scene) -> None:
    canvas, pts, color, thickness, _ = scene
    want = cv2.drawContours(canvas.copy(), [pts.reshape(-1, 1, 2)], -1, color, thickness)
    got = native.polylines(canvas.copy(), [pts], True, color, thickness)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(scenes(max_points=2))
def test_line_as_cv2(scene) -> None:
    canvas, pts, color, thickness, _ = scene
    p0, p1 = tuple(int(v) for v in pts[0]), tuple(int(v) for v in pts[-1])
    want = cv2.line(canvas.copy(), p0, p1, color, thickness)
    got = native.line(canvas.copy(), p0, p1, color, thickness)
    np.testing.assert_array_equal(got, want)


@SETTINGS
@given(scenes(max_points=1))
def test_filled_circle_as_cv2(scene) -> None:
    canvas, pts, color, _, radius = scene
    center = tuple(int(v) for v in pts[0])
    want = cv2.circle(canvas.copy(), center, radius, color, -1)
    got = native.circle(canvas.copy(), center, radius, color)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [0, 1, 2, 5, 12, 40])
def test_filled_circles_near_every_edge_as_cv2(radius: int) -> None:
    canvas = np.zeros((30, 37, 3), np.uint8)
    for cx in (-radius - 1, -radius, -1, 0, 1, 18, 35, 36, 37, 36 + radius, 37 + radius):
        for cy in (-radius, 0, 15, 29, 29 + radius):
            want = cv2.circle(canvas.copy(), (cx, cy), radius, (9, 200, 77), -1)
            np.testing.assert_array_equal(native.circle(canvas.copy(), (cx, cy), radius, (9, 200, 77)), want)


def test_colour_conversion_as_cv2() -> None:
    """Float components round half to even and saturate; missing ones are 0."""
    canvas = np.zeros((4, 4, 4), np.uint8)
    for color in [(0.5, 1.5, 2.5, 300.0), (254.5, -3, 7.49), (128,)]:
        want = cv2.circle(canvas.copy(), (2, 2), 1, color, -1)
        got = native.circle(canvas.copy(), (2, 2), 1, color)
        np.testing.assert_array_equal(got, want)


def test_refusals() -> None:
    with pytest.raises(TypeError, match="int32"):
        native.fill_poly(np.zeros((8, 8, 3), np.uint8), [np.zeros((3, 2), np.int64)], (1, 2, 3))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.line(np.zeros((8, 8, 3), np.uint8)[:, ::2], (0, 0), (3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match="radius"):
        native.circle(np.zeros((8, 8, 3), np.uint8), (3, 3), -2, (1, 1, 1))


@pytest.mark.parametrize("ksize", range(1, 41))
def test_box_blur_as_cv2(ksize: int) -> None:
    rng = np.random.default_rng(ksize)
    for cn in (3, 4):
        h, w = rng.integers(ksize // 2 + 1, 90, 2)
        img = rng.integers(0, 256, (h, w, cn)).astype(np.uint8)
        np.testing.assert_array_equal(port_vis.box_blur(img, ksize), cv2.blur(img, (ksize, ksize)))
        binary = ((img > 128) * 255).astype(np.uint8)  # many ties between two levels
        np.testing.assert_array_equal(port_vis.box_blur(binary, ksize), cv2.blur(binary, (ksize, ksize)))


def test_box_blur_grey() -> None:
    img = np.random.default_rng(1).integers(0, 256, (33, 47)).astype(np.uint8)
    np.testing.assert_array_equal(port_vis.box_blur(img, 5), cv2.blur(img, (5, 5)))


@pytest.mark.parametrize("colour_map", range(22))
def test_apply_color_map_as_cv2(colour_map: int) -> None:
    grey = np.random.default_rng(colour_map).integers(0, 256, (19, 23)).astype(np.uint8)
    want = cv2.cvtColor(cv2.applyColorMap(grey, colour_map), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(port_vis.apply_color_map(grey, colour_map), want)


@pytest.mark.parametrize("name", ["viridis", "jet", "tab20", "Set1", "coolwarm_r", "gray", "magma"])
def test_colormap_rgba_as_matplotlib(name: str) -> None:
    cmap = matplotlib.colormaps[name]
    rng = np.random.default_rng(3)
    x64 = np.concatenate([rng.uniform(-0.2, 1.2, 500), [0.0, 1.0, np.nan, -0.0, 1 - 1e-17, 0.999999]])
    np.testing.assert_array_equal(port_vis.colormap_rgba(name, x64), cmap(x64))
    x32 = x64.astype(np.float32)  # multiplied in float32 as matplotlib does
    np.testing.assert_array_equal(port_vis.colormap_rgba(name, x32), cmap(x32))
    ints = rng.integers(-3, cmap.N + 3, 50)
    np.testing.assert_array_equal(port_vis.colormap_rgba(name, ints), cmap(ints))
    for v in (0.0, 0.5, 1.0, 0.3333, 2.0, -1.0):
        assert port_vis.colormap_rgba(name, v) == cmap(v)
    with pytest.raises(ValueError, match="not a matplotlib colormap"):
        port_vis.colormap_rgba("no_such_map", 0.5)


def test_every_matplotlib_colormap_is_tabled() -> None:
    for name in matplotlib.colormaps:
        cmap = matplotlib.colormaps[name]
        for v in (0.0, 0.25, 0.5, 1.0):
            assert port_vis.colormap_rgba(name, v) == cmap(v), name


def test_golden_set_is_what_the_script_writes() -> None:
    spec = importlib.util.spec_from_file_location("make_raster_golden", ROOT / "scripts" / "make_raster_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fresh = module.golden()
    with np.load(ROOT / "tiatoolbox_tpu_torch" / "data" / "raster_golden.npz") as committed:
        assert sorted(committed.files) == sorted(fresh)
        for name, value in fresh.items():
            np.testing.assert_array_equal(committed[name], value, err_msg=name)


def test_golden_set_replays() -> None:
    """The check the smoke runs on the card machine passes here too."""
    from tiatoolbox_tpu_torch.data.render_golden import check_graph_golden, check_raster_golden

    assert check_raster_golden() > 0
    graph = check_graph_golden()
    assert graph["clusters"] > 4 and graph["edges"] > 0
