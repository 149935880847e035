"""Overlay helpers and the annotation renderer (counterpart of ``tiatoolbox_tpu/utils/visualization.py``).

Everything here runs on the host, as JAX's does. JAX draws with cv2 and
colours with matplotlib; the port has neither, so:

- the drawing goes through the port's host C++ rasteriser
  (``csrc/raster.cpp`` through ``native.fill_poly``, ``native.polylines``,
  ``native.line`` and ``native.circle``), OpenCV's ``LINE_8`` walks bit for
  bit;
- ``cv2.blur`` is ``box_blur``, the port's one box filter (``native.blur``,
  ``csrc/imgproc.cpp``), bit for bit;
- ``cv2.applyColorMap`` is a lookup in the ``cv2_<id>`` tables of
  ``data/colormaps.npz``;
- matplotlib's colormaps are ``colormap_rgba``, ``Colormap.__call__``'s
  indexing of the ``mpl_<name>`` lookup tables of ``data/colormaps.npz``
  (``scripts/make_colormaps.py`` writes both).
"""

from __future__ import annotations

import colorsys

import numpy as np

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.annotation.geometry import LineString, Point, Polygon, _Multi
from tiatoolbox_tpu_torch.utils.store_conversion import colour_tables

# OpenCV's colormap id of JET, ``overlay_probability_map``'s default (``cv2.COLORMAP_JET``)
COLORMAP_JET = 2


def colormap_rgba(name: str, x):
    """``matplotlib.colormaps[name](x)``: RGBA floats in [0, 1].

    Floats index ``floor(x * N)`` (``x == 1`` takes the last colour, below 0
    the under colour, at or above 1 the over colour, NaN the bad colour),
    multiplied in ``x``'s own float type as matplotlib does; integers index
    the table directly. A scalar gives a tuple, an array ``[..., 4]``.

    Raises:
        ValueError: ``name`` is not one of matplotlib's registered colormaps.
    """
    lut = colour_tables().get(f"mpl_{name}")
    if lut is None:
        msg = f"{name!r} is not a matplotlib colormap name."
        raise ValueError(msg)
    n = len(lut) - 3
    xa = np.array(x, copy=True)
    if xa.dtype.kind == "f":
        xa *= n
        xa[xa == n] = n - 1
    mask_under = xa < 0
    mask_over = xa >= n
    mask_bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        xa = xa.astype(int)
    xa[mask_under] = n
    xa[mask_over] = n + 1
    xa[mask_bad] = n + 2
    rgba = lut.take(xa, axis=0, mode="clip")
    if not np.iterable(x):
        return tuple(rgba)
    return rgba


def apply_color_map(grey: np.ndarray, colour_map: int) -> np.ndarray:
    """``cv2.cvtColor(cv2.applyColorMap(grey, colour_map), cv2.COLOR_BGR2RGB)`` of a uint8 image."""
    table = colour_tables().get(f"cv2_{int(colour_map)}")
    if table is None:
        msg = f"Unknown OpenCV colormap id {colour_map}."
        raise ValueError(msg)
    return table[np.asarray(grey, np.uint8)]


def box_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.blur(img, (ksize, ksize))`` of a uint8 ``[h, w]`` or ``[h, w, c]`` image.

    The port's one blur, ``native.blur`` (``csrc/imgproc.cpp``): box sums
    over ``BORDER_REFLECT_101`` padding with the anchor at ``ksize // 2``,
    the mean rounded as OpenCV rounds it (23-bit fixed point up to
    255 * ksize**2 <= 65535; above that float32 over the row's 8-wide
    vectors and float64 over its remaining elements, half to even).
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        msg = f"box_blur takes uint8 images, got {img.dtype}."
        raise TypeError(msg)
    k = int(ksize)
    if k < 1:
        msg = f"ksize must be positive, got {ksize}."
        raise ValueError(msg)
    return native.blur(img, (k, k)).reshape(img.shape)


def random_colors(num_colors: int, *, bright: bool = True) -> np.ndarray:
    """Visually distinct RGB colours in [0, 1] (JAX :18-25)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(i / num_colors, 1, brightness) for i in range(num_colors)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    rng = np.random.default_rng(0)
    order = rng.permutation(num_colors)
    return np.array(colors)[order]


def overlay_prediction_mask(
    img: np.ndarray,
    prediction: np.ndarray,
    alpha: float = 0.35,
    label_info: dict | None = None,
    min_val: float = 0.0,
    *,
    return_ax: bool = False,  # noqa: ARG001 - API parity, no matplotlib
) -> np.ndarray:
    """Overlay a class-prediction mask on an RGB image (JAX :28-59)."""
    img = np.asarray(img)
    prediction = np.asarray(prediction)
    if img.shape[:2] != prediction.shape[:2]:
        msg = "Mismatch shape between img and prediction."
        raise ValueError(msg)
    if img.dtype != np.uint8:
        img = np.clip(img * 255 if img.max() <= 1 else img, 0, 255).astype(np.uint8)
    predicted_classes = sorted(np.unique(prediction).tolist())
    if label_info is None:
        colors = (random_colors(len(predicted_classes)) * 255).astype(np.uint8)
        label_info = {c: (str(c), tuple(colors[i])) for i, c in enumerate(predicted_classes)}
    overlay = img.copy().astype(float)
    rgb = img.copy()
    for class_value, (_, color) in label_info.items():
        sel = prediction == class_value
        if class_value <= min_val:
            continue
        rgb[sel] = color
    overlay = (1 - alpha) * overlay + alpha * rgb.astype(float)
    return np.clip(overlay, 0, 255).astype(np.uint8)


def colourise_image(img: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """Colour-map a single-channel image to uint8 RGB; RGB passes through (JAX :62-78)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] >= 3:
        return img
    chan = np.squeeze(img).astype(np.float32)
    rng = chan.max() - chan.min()
    if rng > 0:
        chan = (chan - chan.min()) / rng
    rgba = colormap_rgba(cmap, chan)
    return (rgba[..., :3] * 255).astype(np.uint8)


def overlay_probability_map(
    img: np.ndarray,
    prediction: np.ndarray,
    alpha: float = 0.35,
    colour_map: int = COLORMAP_JET,
    min_val: float = 0.0,
    *,
    return_ax: bool = False,  # noqa: ARG001
) -> np.ndarray:
    """Overlay a [0, 1] probability heat map on an RGB image (JAX :81-103).

    ``colour_map`` is an OpenCV colormap id (``COLORMAP_JET`` = 2).
    """
    prediction = np.asarray(prediction, dtype=np.float32)
    if prediction.max() > 1 + 1e-6 or prediction.min() < 0:
        msg = "Probability map values must be within [0, 1]."
        raise ValueError(msg)
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255 if img.max() <= 1 else img, 0, 255).astype(np.uint8)
    heat = apply_color_map((prediction * 255).astype(np.uint8), colour_map)
    sel = prediction >= min_val
    out = img.copy().astype(float)
    out[sel] = (1 - alpha) * out[sel] + alpha * heat[sel].astype(float)
    return np.clip(out, 0, 255).astype(np.uint8)


def overlay_prediction_contours(
    canvas: np.ndarray,
    inst_dict: dict,
    type_colours: dict | None = None,
    line_thickness: int = 2,
    *,
    draw_dot: bool = False,
) -> np.ndarray:
    """Draw instance contours (and centroids) on a copy of an image (JAX :106-130)."""
    overlay = np.array(canvas, copy=True, order="C")
    for info in inst_dict.values():
        contour = np.asarray(info["contours"], dtype=np.int32).reshape(-1, 2)
        inst_type = info.get("type")
        if type_colours is not None and inst_type in type_colours:
            colour = type_colours[inst_type][1]
        else:
            colour = (255, 255, 0)
        colour = tuple(int(c) for c in colour)
        if line_thickness < 0:
            native.fill_poly(overlay, [contour], colour)
        else:
            native.polylines(overlay, [contour], True, colour, line_thickness)
        if draw_dot:
            centroid = np.asarray(info["centroid"], dtype=int)
            native.circle(overlay, tuple(centroid), 3, (255, 0, 0))
    return overlay


def plot_graph(
    canvas: np.ndarray,
    nodes: np.ndarray,
    edges: np.ndarray,
    node_colors=(255, 0, 0),
    node_size: int = 5,
    edge_colors=(0, 0, 0),
    edge_size: int = 5,
) -> np.ndarray:
    """Draw a graph (nodes ``[N, 2]`` as (y, x), edges ``[M, 2]``) onto an image, in place (JAX :133-154)."""
    if isinstance(node_colors, tuple):
        node_colors = [node_colors] * len(nodes)
    if isinstance(edge_colors, tuple):
        edge_colors = [edge_colors] * len(edges)
    nodes = np.asarray(nodes, int)
    for (src, dst), color in zip(np.asarray(edges, int), edge_colors):
        native.line(canvas, tuple(nodes[src][::-1]), tuple(nodes[dst][::-1]), color, edge_size)
    for node, color in zip(nodes, node_colors):
        native.circle(canvas, tuple(node[::-1]), node_size, color)
    return canvas


class AnnotationRenderer:
    """Rasterise ``AnnotationStore`` contents to RGBA tiles (JAX :157-323).

    Args:
        score_prop: Property used to colour annotations.
        mapper: dict value -> RGBA, ``"categorical"``, a matplotlib colormap
            name, or a callable.
        where: Filter predicate passed to store queries.
        score_fn: Applied to the property before a continuous colormap.
        max_scale: Above this scale small annotations are skipped
            (``zoomed_out_strat``'s decimation: areas under 0.05 % of the
            tile's baseline area).
        thickness: Outline thickness (-1 = filled).
        edge_thickness: Border thickness when filled.
        zoomed_out_strat: ``"decimate"`` or ``"scale"`` when zoomed far out.
        blur_radius: Box blur of the rendered tile, in pixels (0 = none).
        secondary_cmap: ``{"type": t, "score_prop": p, "mapper": m}``:
            annotations of type ``t`` coloured by ``p`` through ``m``.
    """

    def __init__(
        self,
        score_prop: str | None = None,
        mapper=None,
        where=None,
        score_fn=None,
        max_scale: int = 8,
        thickness: int = -1,
        edge_thickness: int = 1,
        zoomed_out_strat: str = "decimate",
        *,
        blur_radius: int = 0,
        secondary_cmap: dict | None = None,
    ) -> None:
        self.score_prop = score_prop
        self.secondary_cmap = secondary_cmap
        self.where = where
        self.score_fn = score_fn or (lambda x: x)
        self.max_scale = max_scale
        self.thickness = thickness
        self.edge_thickness = edge_thickness
        self.zoomed_out_strat = zoomed_out_strat
        self.blur_radius = blur_radius
        self.score_range: tuple[float, float] | None = None
        self._categorical_colors: dict = {}
        if mapper is None:
            mapper = "categorical"
        self.mapper = mapper

    def get_color(self, properties: dict) -> tuple[int, int, int, int]:
        """RGBA colour of an annotation from its properties (JAX :199-250)."""
        sec = self.secondary_cmap
        if (
            sec is not None
            and properties.get("type") == sec.get("type")
            and sec.get("score_prop") in properties
        ):
            rgba = self._apply_mapper(sec.get("mapper"), properties[sec["score_prop"]])
            if rgba is not None:
                return rgba
        value = properties.get(self.score_prop) if self.score_prop else None
        if callable(self.mapper):
            rgba = self.mapper(value)
            return tuple(int(255 * c) for c in rgba)
        if isinstance(self.mapper, dict):
            rgba = self.mapper.get(value, (0, 1, 0, 1))
            return tuple(int(255 * c) for c in rgba)
        if isinstance(self.mapper, str) and self.mapper != "categorical" and isinstance(value, (int, float)):
            # a continuous matplotlib colormap over score_range
            score = self.score_fn(value)
            lo, hi = self.score_range or (0.0, 1.0)
            rgba = colormap_rgba(self.mapper, (score - lo) / max(hi - lo, 1e-9))
            return tuple(int(255 * c) for c in rgba)
        key = value if value is not None else properties.get("type", "default")
        if key not in self._categorical_colors:
            idx = len(self._categorical_colors)
            palette = random_colors(32)
            color = palette[idx % 32]
            self._categorical_colors[key] = (
                int(color[0] * 255),
                int(color[1] * 255),
                int(color[2] * 255),
                255,
            )
        return self._categorical_colors[key]

    @staticmethod
    def _apply_mapper(mapper, value) -> tuple[int, int, int, int] | None:
        """Apply a callable, dict or matplotlib-name mapper to a raw value (JAX :252-266)."""
        if callable(mapper):
            rgba = mapper(value)
            return tuple(int(255 * c) for c in rgba)
        if isinstance(mapper, dict):
            rgba = mapper.get(value)
            return None if rgba is None else tuple(int(255 * c) for c in rgba)
        if isinstance(mapper, str) and isinstance(value, (int, float)):
            rgba = colormap_rgba(mapper, float(value))
            return tuple(int(255 * c) for c in rgba)
        return None

    def render_annotations(
        self,
        store,
        bounds,
        scale: float = 1.0,
        output_size: int = 256,
        res: int = 1,  # noqa: ARG002 - API parity
    ) -> np.ndarray:
        """Render the store's annotations within ``bounds`` to an RGBA tile (JAX :268-289)."""
        x0, y0, x1, y1 = bounds
        canvas = np.zeros((output_size, output_size, 4), np.uint8)
        min_area = 0.0005 * (x1 - x0) * (y1 - y0) if scale > self.max_scale else None
        results = store.query(bounds, where=self.where, min_area=min_area)
        sf = output_size / max(x1 - x0, 1e-9)
        for ann in results.values():
            color = self.get_color(ann.properties)
            self._draw_geometry(canvas, ann.geometry, (x0, y0), sf, color)
        if self.blur_radius > 0:
            canvas = box_blur(canvas, self.blur_radius)
        return canvas

    def _draw_geometry(self, canvas, geom, origin, sf, color) -> None:
        if isinstance(geom, _Multi):
            for g in geom.geoms:
                self._draw_geometry(canvas, g, origin, sf, color)
            return
        ox, oy = origin
        if isinstance(geom, Point):
            center = (int((geom.x - ox) * sf), int((geom.y - oy) * sf))
            native.circle(canvas, center, max(int(4 * sf), 1), color)
            return
        if isinstance(geom, LineString):
            pts = ((geom.coords_array - [ox, oy]) * sf).astype(np.int32)
            native.polylines(canvas, [pts], False, color, 2)
            return
        if isinstance(geom, Polygon):
            shell = ((geom.shell - [ox, oy]) * sf).astype(np.int32)
            if self.thickness == -1:
                native.fill_poly(canvas, [shell], color)
                for hole in geom.holes:
                    hole_pts = ((hole - [ox, oy]) * sf).astype(np.int32)
                    native.fill_poly(canvas, [hole_pts], (0, 0, 0, 0))
                if self.edge_thickness > 0:
                    native.polylines(canvas, [shell], True, (0, 0, 0, 255), self.edge_thickness)
            else:
                native.polylines(canvas, [shell], True, color, self.thickness)
