"""Golden sets for rendering and the slide graph, checked where cv2 and the JAX package are absent.

``scripts/make_raster_golden.py`` draws ``raster_cases()`` with cv2, blurs
and colour-maps ``blur_cases()`` and ``colormap_cases()`` with cv2, and
builds ``graph_case()``'s graph with the JAX package's
``SlideGraphConstructor``; it writes the results to ``raster_golden.npz``
beside this file. ``check_raster_golden`` and ``check_graph_golden`` replay
the same seeded cases through the port and compare bit for bit (clusters and
``edge_index`` equal, the PCA colours within 1e-12), so ``chip_smoke.py``
can hold the port to cv2 and JAX on a machine that has neither.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().parent / "raster_golden.npz"
N_DRAW_CASES = 48
BLUR_SIZES = (2, 3, 5, 6, 8, 16, 17, 22, 31)
PCA_TOL = 1e-12


def _points(rng, n: int, h: int, w: int) -> np.ndarray:
    span = int(rng.choice([1, 2, 10]))
    lo, hi = -span * max(h, w) // 2, max(h, w) + span * max(h, w) // 2
    return rng.integers(lo, hi, (n, 2)).astype(np.int32)


def raster_cases() -> list[dict]:
    """Seeded scenes: a canvas and a list of draw operations on it.

    Each operation is ``(kind, args)``: ``("fill", (points, color))``,
    ``("hole", (points,))`` (a fill in ``(0, 0, 0, 0)``),
    ``("poly", (points, closed, color, thickness))``,
    ``("line", (p0, p1, color, thickness))`` or
    ``("circle", (center, radius, color))`` (filled).
    """
    cases = []
    for i in range(N_DRAW_CASES):
        rng = np.random.default_rng(1000 + i)
        h, w = (int(v) for v in rng.integers(8, 72, 2))
        cn = int(rng.choice([3, 4]))
        canvas = rng.integers(0, 256, (h, w, cn)).astype(np.uint8) if i % 3 == 0 else np.zeros((h, w, cn), np.uint8)
        ops = []
        for _ in range(int(rng.integers(2, 7))):
            kind = str(rng.choice(["fill", "hole", "poly", "line", "circle"]))
            color = tuple(int(v) for v in rng.integers(0, 256, 4))
            thickness = int(rng.integers(1, 6))
            pts = _points(rng, int(rng.integers(1, 14)), h, w)
            if kind == "fill":
                ops.append((kind, (pts, color)))
            elif kind == "hole":
                ops.append((kind, (pts,)))
            elif kind == "poly":
                ops.append((kind, (pts, bool(rng.integers(0, 2)), color, thickness)))
            elif kind == "line":
                ops.append((kind, (tuple(int(v) for v in pts[0]), tuple(int(v) for v in pts[-1]), color, thickness)))
            else:
                ops.append((kind, (tuple(int(v) for v in pts[0]), int(rng.integers(1, 13)), color)))
        cases.append({"canvas": canvas, "ops": ops})
    return cases


def blur_cases() -> list[tuple[np.ndarray, int]]:
    """Seeded RGBA images, one per box size in ``BLUR_SIZES``."""
    out = []
    for k in BLUR_SIZES:
        rng = np.random.default_rng(2000 + k)
        img = rng.integers(0, 256, (41, 53, 4)).astype(np.uint8)
        img[::2] = (img[::2] > 128) * np.uint8(255)  # rows of two levels, where the rounding ties
        out.append((img, k))
    return out


def colormap_cases() -> np.ndarray:
    """One seeded grey image for every OpenCV colormap id."""
    return np.random.default_rng(3000).integers(0, 256, (17, 19)).astype(np.uint8)


def graph_case() -> tuple[np.ndarray, np.ndarray]:
    """Seeded patch positions (two tissue blobs) and features for ``SlideGraphConstructor.build``."""
    rng = np.random.default_rng(4000)
    centres = np.array([[1500.0, 1500.0], [6000.0, 3000.0]])
    points = np.concatenate([c + rng.normal(0, 900, (60, 2)) for c in centres])
    features = np.concatenate([rng.normal(m, 1.0, (60, 16)) for m in (0.0, 3.0)])
    return np.round(points), features


def draw_port(case: dict) -> np.ndarray:
    """A scene drawn by the port's rasteriser."""
    from tiatoolbox_tpu_torch import native

    img = case["canvas"].copy()
    for kind, args in case["ops"]:
        if kind == "fill":
            native.fill_poly(img, [args[0]], args[1])
        elif kind == "hole":
            native.fill_poly(img, [args[0]], (0, 0, 0, 0))
        elif kind == "poly":
            native.polylines(img, [args[0]], args[1], args[2], args[3])
        elif kind == "line":
            native.line(img, *args)
        else:
            native.circle(img, args[0], args[1], args[2])
    return img


def check_raster_golden(path: Path = GOLDEN_PATH) -> int:
    """Replay every draw, blur and colour map through the port; the number of arrays checked.

    Raises:
        AssertionError: an array differs from the golden set, naming it.
    """
    from tiatoolbox_tpu_torch.utils.visualization import apply_color_map, box_blur

    checked = 0
    with np.load(path) as golden:
        for i, case in enumerate(raster_cases()):
            want = golden[f"draw_{i}"]
            got = draw_port(case)
            if not np.array_equal(got, want):
                msg = f"draw_{i}: {int(np.sum(np.any(got != want, axis=-1)))} pixels differ from cv2's."
                raise AssertionError(msg)
            checked += 1
        for img, k in blur_cases():
            if not np.array_equal(box_blur(img, k), golden[f"blur_{k}"]):
                msg = f"blur_{k} differs from cv2.blur's."
                raise AssertionError(msg)
            checked += 1
        grey = colormap_cases()
        for cmap_id in range(int(golden["n_colormaps"])):
            if not np.array_equal(apply_color_map(grey, cmap_id), golden[f"colormap_{cmap_id}"]):
                msg = f"colormap_{cmap_id} differs from cv2.applyColorMap's."
                raise AssertionError(msg)
            checked += 1
    return checked


def check_graph_golden(path: Path = GOLDEN_PATH) -> dict:
    """Build the seeded graph with the port; clusters and edges must be JAX's.

    Returns:
        ``{"clusters": n, "edges": m}``.

    Raises:
        AssertionError: the clusters, the edges or the PCA colours differ.
    """
    from tiatoolbox_tpu_torch.tools.graph import SlideGraphConstructor

    points, features = graph_case()
    graph = SlideGraphConstructor.build(points, features)
    with np.load(path) as golden:
        for key in ("x", "edge_index", "coordinates"):
            if not np.array_equal(graph[key], golden[f"graph_{key}"]):
                msg = f"graph {key} differs from the JAX package's."
                raise AssertionError(msg)
        pca = SlideGraphConstructor._pca_reducer(graph)  # noqa: SLF001
        if not np.allclose(pca, golden["graph_pca"], rtol=0, atol=PCA_TOL):
            msg = f"graph PCA colours differ from the JAX package's by {np.abs(pca - golden['graph_pca']).max()}."
            raise AssertionError(msg)
    return {"clusters": int(len(graph["x"])), "edges": int(graph["edge_index"].shape[1])}
