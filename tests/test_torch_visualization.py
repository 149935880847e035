"""``utils/visualization.py``: the port against the JAX package, bit for bit.

Tolerance: none. Seeded numpy inputs go through JAX's overlays and
``AnnotationRenderer`` (cv2 and matplotlib there) and the port's (its own
rasteriser and colour tables): every output array and colour equal. The
renderer scenarios are those of ``tests/test_visualization.py`` (filled,
outline, ``where``, dict, callable, continuous, categorical, decimated,
blur, scaled window, secondary colour map), over the same three-annotation
store and over a seeded store of a few hundred nucleus-like polygons with
holes, points and lines, in both store backends.
"""

from __future__ import annotations

import numpy as np
import pytest

from tiatoolbox_tpu.annotation import geometry as jax_geometry
from tiatoolbox_tpu.annotation import storage as jax_storage
from tiatoolbox_tpu.utils import visualization as jax_vis
from tiatoolbox_tpu_torch.annotation import geometry as port_geometry
from tiatoolbox_tpu_torch.annotation import storage as port_storage
from tiatoolbox_tpu_torch.utils import visualization as port_vis


def _three(geometry, storage):
    s = storage.DictionaryStore()
    s.append(
        storage.Annotation(geometry.Polygon([(10, 10), (120, 10), (120, 120), (10, 120)]), {"type": "tumour", "prob": 0.9}),
        key="big",
    )
    s.append(storage.Annotation(geometry.Point(200, 200).buffer(3), {"type": "cell", "prob": 0.2}), key="tiny")
    s.append(storage.Annotation(geometry.LineString([(0, 250), (255, 250)]), {"type": "vessel"}), key="line")
    return s


def _nuclei_annotations(geometry, storage, seed: int = 0, n: int = 300, extent: int = 1024):
    """Seeded star-shaped polygons (some with holes), points and lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cx, cy = rng.uniform(-20, extent + 20, 2)
        k = int(rng.integers(5, 24))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(3, 25, k)
        shell = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
        props = {"type": int(rng.integers(0, 5)), "prob": float(rng.uniform()), "label": f"c{i % 3}"}
        if i % 17 == 0:
            hole = np.stack([cx + 2 * np.cos(ang[:4]), cy + 2 * np.sin(ang[:4])], 1)
            geom = geometry.Polygon(shell, holes=[hole])
        elif i % 23 == 0:
            geom = geometry.Point(cx, cy)
        elif i % 29 == 0:
            geom = geometry.LineString(shell[:4])
        else:
            geom = geometry.Polygon(shell)
        out.append((geom, props))
    return out


def _nuclei_store(geometry, storage, backend: str, tmp_path=None):
    store = storage.DictionaryStore() if backend == "dict" else storage.SQLiteStore(tmp_path)
    for i, (geom, props) in enumerate(_nuclei_annotations(geometry, storage)):
        store.append(storage.Annotation(geom, props), key=f"a{i}")
    return store


@pytest.fixture()
def stores():
    return _three(jax_geometry, jax_storage), _three(port_geometry, port_storage)


RENDERERS = {
    "filled": ({}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "outline": ({"thickness": 2}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "where": ({"where": 'props["type"] == "cell"'}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "vessel": ({"where": 'props["type"] == "vessel"'}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "dict": ({"score_prop": "type", "mapper": {"tumour": (1, 0, 0, 1)}}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "continuous": ({"score_prop": "prob", "mapper": "viridis"}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "callable": ({"score_prop": "prob", "mapper": lambda v: (v or 0, 0.5, 0, 1)}, dict(bounds=(0, 0, 256, 256))),
    "decimated": ({"max_scale": 4}, dict(bounds=(0, 0, 256, 256), scale=8.0)),
    "blur": ({"blur_radius": 5}, dict(bounds=(0, 0, 256, 256), scale=1.0)),
    "scaled": ({}, dict(bounds=(0, 0, 512, 512), scale=2.0, output_size=256)),
    "edge3": ({"edge_thickness": 3}, dict(bounds=(-5.5, 3.25, 250.5, 259.25), scale=1.0)),
    "secondary": (
        {"score_prop": "type", "secondary_cmap": {"type": "cell", "score_prop": "prob", "mapper": "jet"}},
        dict(bounds=(0, 0, 256, 256)),
    ),
}


@pytest.mark.parametrize("case", sorted(RENDERERS))
def test_renderer_scenarios(case: str, stores) -> None:
    kwargs, call = RENDERERS[case]
    jax_store, port_store = stores
    want = jax_vis.AnnotationRenderer(**kwargs).render_annotations(jax_store, **call)
    got = port_vis.AnnotationRenderer(**kwargs).render_annotations(port_store, **call)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["dict", "sqlite"])
@pytest.mark.parametrize(
    ("kwargs", "bounds", "scale", "size"),
    [
        ({}, (0, 0, 256, 256), 1.0, 256),
        ({"score_prop": "prob", "mapper": "magma", "edge_thickness": 2}, (128, 128, 640, 640), 2.0, 256),
        ({"thickness": 3, "score_prop": "label"}, (-64, -64, 192, 192), 1.0, 256),
        ({"max_scale": 2, "blur_radius": 8}, (0, 0, 1024, 1024), 4.0, 256),
        ({"score_prop": "type", "mapper": {k: (k / 4, 1 - k / 4, 0.5, 1) for k in range(5)}}, (0, 0, 1100, 1100), 8.0, 128),
        ({"blur_radius": 20}, (300, 200, 556, 456), 1.0, 256),
    ],
)
def test_renderer_many_annotations(backend, kwargs, bounds, scale, size, tmp_path) -> None:
    jax_store = _nuclei_store(jax_geometry, jax_storage, backend, tmp_path / "jax.db")
    port_store = _nuclei_store(port_geometry, port_storage, backend, tmp_path / "port.db")
    want = jax_vis.AnnotationRenderer(**kwargs).render_annotations(jax_store, bounds, scale=scale, output_size=size)
    got = port_vis.AnnotationRenderer(**kwargs).render_annotations(port_store, bounds, scale=scale, output_size=size)
    np.testing.assert_array_equal(got, want)
    assert got[..., 3].any()


@pytest.mark.parametrize(
    "props",
    [{"type": "a"}, {"type": "b"}, {}, {"prob": 0.5}, {"prob": 1.0}, {"prob": 0}, {"prob": -0.5}, {"prob": 7}],
)
@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"score_prop": "prob", "mapper": "viridis"},
        {"score_prop": "prob", "mapper": "Set1", "score_fn": lambda x: x * 2},
        {"score_prop": "prob", "mapper": lambda v: (0.25, 0.5, 0.75, 1.0)},
        {"score_prop": "prob", "mapper": {0.5: (1, 0, 0, 1)}},
        {"score_prop": "type", "secondary_cmap": {"type": "a", "score_prop": "prob", "mapper": "coolwarm"}},
    ],
)
def test_get_color(props, kwargs) -> None:
    jax_r, port_r = jax_vis.AnnotationRenderer(**kwargs), port_vis.AnnotationRenderer(**kwargs)
    jax_r.score_range = port_r.score_range = (-1.0, 2.0)
    for _ in range(2):  # categorical colours are cached by first sight
        assert port_r.get_color(props) == jax_r.get_color(props)


def test_categorical_palette_order() -> None:
    jax_r, port_r = jax_vis.AnnotationRenderer(), port_vis.AnnotationRenderer()
    for key in [f"k{i}" for i in range(40)] + ["k3", "k39"]:
        assert port_r.get_color({"type": key}) == jax_r.get_color({"type": key})


@pytest.mark.parametrize("n", [1, 3, 8, 32, 100])
def test_random_colors(n: int) -> None:
    for bright in (True, False):
        np.testing.assert_array_equal(port_vis.random_colors(n, bright=bright), jax_vis.random_colors(n, bright=bright))


@pytest.mark.parametrize("seed", range(3))
def test_overlay_prediction_mask(seed: int) -> None:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (48, 40, 3)).astype(np.uint8)
    pred = rng.integers(0, 5, (48, 40))
    for kwargs in ({}, {"alpha": 0.7, "min_val": 1}, {"label_info": {1: ("x", (255, 0, 0)), 3: ("y", (0, 9, 200))}}):
        np.testing.assert_array_equal(
            port_vis.overlay_prediction_mask(img, pred, **kwargs), jax_vis.overlay_prediction_mask(img, pred, **kwargs)
        )
    as_float = img.astype(np.float32) / 255
    np.testing.assert_array_equal(
        port_vis.overlay_prediction_mask(as_float, pred), jax_vis.overlay_prediction_mask(as_float, pred)
    )
    with pytest.raises(ValueError, match="Mismatch"):
        port_vis.overlay_prediction_mask(img, pred[:4])


@pytest.mark.parametrize("colour_map", [2, 0, 11, 20])
def test_overlay_probability_map(colour_map: int) -> None:
    rng = np.random.default_rng(colour_map)
    img = rng.integers(0, 256, (37, 51, 3)).astype(np.uint8)
    prob = rng.uniform(0, 1, (37, 51)).astype(np.float32)
    for kwargs in ({}, {"alpha": 0.6, "min_val": 0.4}):
        np.testing.assert_array_equal(
            port_vis.overlay_probability_map(img, prob, colour_map=colour_map, **kwargs),
            jax_vis.overlay_probability_map(img, prob, colour_map=colour_map, **kwargs),
        )
    assert port_vis.COLORMAP_JET == 2
    with pytest.raises(ValueError, match="0, 1"):
        port_vis.overlay_probability_map(img, prob * 3)


@pytest.mark.parametrize("cmap", ["viridis", "jet", "gray", "tab10"])
def test_colourise_image(cmap: str) -> None:
    rng = np.random.default_rng(4)
    for img in (rng.uniform(-3, 9, (21, 17)), rng.integers(0, 1000, (21, 17, 1)), np.full((5, 6), 2.0)):
        np.testing.assert_array_equal(port_vis.colourise_image(img, cmap), jax_vis.colourise_image(img, cmap))
    rgb = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    assert port_vis.colourise_image(rgb) is not None
    np.testing.assert_array_equal(port_vis.colourise_image(rgb), jax_vis.colourise_image(rgb))


@pytest.mark.parametrize("thickness", [1, 2, 3, -1])
def test_overlay_prediction_contours(thickness: int) -> None:
    rng = np.random.default_rng(thickness + 5)
    canvas = rng.integers(0, 256, (96, 80, 3)).astype(np.uint8)
    inst = {}
    for i in range(30):
        cx, cy = rng.uniform(-10, 100, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        contour = np.stack([cx + 8 * np.cos(ang), cy + 8 * np.sin(ang)], 1).astype(int)
        inst[i] = {"contours": contour.tolist(), "centroid": [cx, cy], "type": i % 4}
    colours = {1: ("a", (0, 255, 0)), 2: ("b", (10, 20, 250))}
    for kwargs in ({}, {"type_colours": colours, "draw_dot": True}):
        want = jax_vis.overlay_prediction_contours(canvas, inst, line_thickness=thickness, **kwargs)
        got = port_vis.overlay_prediction_contours(canvas, inst, line_thickness=thickness, **kwargs)
        np.testing.assert_array_equal(got, want)


def test_plot_graph() -> None:
    rng = np.random.default_rng(8)
    nodes = rng.uniform(-5, 105, (40, 2))
    edges = rng.integers(0, 40, (60, 2))
    node_colors = [tuple(int(v) for v in c) for c in rng.integers(0, 256, (40, 3))]
    for kwargs in ({}, {"node_colors": node_colors, "node_size": 3, "edge_colors": (0, 0, 255), "edge_size": 1}):
        want = jax_vis.plot_graph(np.full((100, 90, 3), 255, np.uint8), nodes, edges, **kwargs)
        got = port_vis.plot_graph(np.full((100, 90, 3), 255, np.uint8), nodes, edges, **kwargs)
        np.testing.assert_array_equal(got, want)
