"""Engine outputs to an AnnotationStore or QuPath JSON (counterpart of
``tiatoolbox_tpu/utils/store_conversion.py:1-290``).

The JAX module's functions, with two replacements, each giving JAX's
output: ``process_contours`` traces with the port's host C++
(``native.find_contours_ccomp``) where JAX calls ``cv2.findContours(mask,
RETR_CCOMP, CHAIN_APPROX_SIMPLE)``, with the same points, contour order and
holes; and ``patch_predictions_as_qupath_json`` picks class colours from
matplotlib's ``tab20`` as JAX does, read from ``data/colormaps.npz``
(``scripts/make_colormaps.py``) since the port has no matplotlib.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.annotation.geometry import Point, Polygon
from tiatoolbox_tpu_torch.annotation.storage import Annotation, SQLiteStore

COLORMAPS_PATH = Path(__file__).resolve().parents[1] / "data" / "colormaps.npz"


@functools.cache
def colour_tables() -> dict[str, np.ndarray]:
    """``data/colormaps.npz``: ``cv2_<id>`` uint8 ``[256, 3]`` RGB and ``tab20``."""
    with np.load(COLORMAPS_PATH) as data:
        return {name: data[name] for name in data.files}


def tab20_colours(class_dict: dict) -> dict:
    """``{class: [r, g, b]}`` as ``colormaps["tab20"].resampled(len(class_dict))``
    picks them for integer classes (matplotlib's ``Colormap.__call__``)."""
    n = max(len(class_dict), 1)
    tab20 = colour_tables()["tab20"]
    x = np.linspace(0, 1, n) * len(tab20)
    x[x == len(tab20)] = len(tab20) - 1
    resampled = tab20[x.astype(int)]
    # an integer below 0 takes the first colour, one at or above n the last
    return {
        idx: [int(c * 255) for c in resampled[min(max(int(idx), 0), n - 1)][:3]]
        for idx in class_dict
    }


def patch_predictions_as_annotations(
    predictions,
    coordinates,
    probabilities=None,
    labels=None,
    class_dict: dict | None = None,
) -> list[Annotation]:
    """Per-patch predictions → box Annotations with class properties."""
    annotations = []
    predictions = np.asarray(predictions)
    coordinates = np.asarray(coordinates)
    for i in range(len(predictions)):
        x0, y0, x1, y1 = (float(v) for v in coordinates[i])
        props: dict = {}
        pred = predictions[i]
        props["type"] = (
            class_dict.get(int(pred), int(pred)) if class_dict else int(pred)
        )
        if probabilities is not None:
            probs = np.asarray(probabilities[i], dtype=float)
            props["prob"] = float(probs[int(pred)])
        if labels is not None:
            props["label"] = (
                class_dict.get(int(labels[i]), int(labels[i]))
                if class_dict
                else int(labels[i])
            )
        annotations.append(
            Annotation(Polygon.from_bounds(x0, y0, x1, y1), props)
        )
    return annotations


def dict_to_store_patch_predictions(
    patch_output: dict,
    scale_factor=(1.0, 1.0),
    class_dict: dict | None = None,
    save_path: Path | None = None,
) -> "SQLiteStore | Path":
    """Patch-prediction dict → SQLiteStore (.db written if save_path)."""
    if "coordinates" not in patch_output:
        msg = "Patch output must contain coordinates."
        raise ValueError(msg)
    coords = np.asarray(patch_output["coordinates"], dtype=float)
    coords = coords * np.tile(np.asarray(scale_factor, dtype=float), 2)
    annotations = patch_predictions_as_annotations(
        patch_output["predictions"],
        coords,
        patch_output.get("probabilities"),
        patch_output.get("labels"),
        class_dict,
    )
    store = SQLiteStore(save_path if save_path is not None else ":memory:")
    store.append_many(annotations)
    store.commit()
    if save_path is not None:
        store.close()
        return Path(save_path)
    return store


def process_contours(
    mask: np.ndarray,
    class_value: int,
    scale_factor=(1.0, 1.0),
    min_area: float = 0,
) -> list[Polygon]:
    """Binary mask → polygons, holes kept (cv2's RETR_CCOMP contours, JAX :82-117)."""
    mask_u8 = (np.asarray(mask) == class_value).astype(np.uint8)
    if mask_u8.sum() == 0:
        return []
    contours, hierarchy = native.find_contours_ccomp(mask_u8)
    if len(contours) == 0:
        return []
    sf = np.asarray(scale_factor, dtype=float)
    polygons = []
    for contour, h in zip(contours, hierarchy):
        if h[3] != -1:  # it's a hole; attached to its parent below
            continue
        shell = contour.astype(float) * sf
        if len(shell) < 3:
            continue
        holes = []
        child = h[2]
        while child != -1:
            hole = contours[child].astype(float) * sf
            if len(hole) >= 3:
                holes.append(hole)
            child = hierarchy[child][0]
        poly = Polygon(shell, holes)
        if poly.area >= min_area:
            polygons.append(poly)
    return polygons


def dict_to_store_semantic_segmentor(
    output: dict,
    scale_factor=(1.0, 1.0),
    class_dict: dict | None = None,
    save_path: Path | None = None,
    offset=(0, 0),
):
    """Semantic-segmentation prediction map → contour-polygon store.

    ``offset`` translates polygons into slide space (reference
    ``utils/misc.py dict_to_store_semantic_segmentor`` offset arg, used
    by the prompt segmentor for interactively selected tiles).
    """
    predictions = np.asarray(output["predictions"])
    classes = [int(c) for c in np.unique(predictions) if c != 0]
    store = SQLiteStore(save_path if save_path is not None else ":memory:")
    annotations = []
    off_x, off_y = (float(v) for v in offset)
    for class_value in classes:
        label = class_dict.get(class_value, class_value) if class_dict else class_value
        for poly in process_contours(predictions, class_value, scale_factor):
            if off_x or off_y:
                shift = np.array([off_x, off_y])
                poly = Polygon(
                    poly.shell + shift, [h + shift for h in poly.holes]
                )
            annotations.append(Annotation(poly, {"type": label}))
    store.append_many(annotations)
    store.commit()
    if save_path is not None:
        store.close()
        return Path(save_path)
    return store


def dict_to_store_instance_segmentor(
    instances: dict,
    scale_factor=(1.0, 1.0),
    class_dict: dict | None = None,
    save_path: Path | None = None,
):
    """Instance dict {key: {box, centroid, contours, prob, type}} → store."""
    sf = np.asarray(scale_factor, dtype=float)
    store = SQLiteStore(save_path if save_path is not None else ":memory:")
    annotations, keys = [], []
    for key, info in instances.items():
        contours = np.asarray(info["contours"], dtype=float) * sf
        if len(contours) < 3:
            continue
        props = {}
        if info.get("type") is not None:
            t = int(info["type"])
            props["type"] = class_dict.get(t, t) if class_dict else t
        if info.get("prob") is not None:
            props["prob"] = float(info["prob"])
        annotations.append(Annotation(Polygon(contours), props))
        keys.append(str(key))
    store.append_many(annotations, keys=keys)
    store.commit()
    if save_path is not None:
        store.close()
        return Path(save_path)
    return store


def dict_to_store_nucleus_detector(
    detections: dict,
    scale_factor=(1.0, 1.0),
    class_dict: dict | None = None,
    save_path: Path | None = None,
):
    """Detection dict {coordinates [N,2], scores, types} → point store."""
    coords = np.asarray(detections["coordinates"], dtype=float) * np.asarray(
        scale_factor, dtype=float
    )
    scores = detections.get("scores")
    types = detections.get("types")
    store = SQLiteStore(save_path if save_path is not None else ":memory:")
    annotations = []
    for i, (x, y) in enumerate(coords):
        props: dict = {}
        if scores is not None:
            props["prob"] = float(scores[i])
        if types is not None:
            t = int(types[i])
            props["type"] = class_dict.get(t, t) if class_dict else t
        annotations.append(Annotation(Point(x, y), props))
    store.append_many(annotations)
    store.commit()
    if save_path is not None:
        store.close()
        return Path(save_path)
    return store


def patch_predictions_as_qupath_json(
    preds,
    class_dict: dict,
    patch_coords,
    *,
    verbose: bool = True,  # noqa: ARG001 - reference API
) -> dict:
    """QuPath GeoJSON dict for per-patch class predictions.

    Reference ``utils/misc.py`` ``patch_predictions_as_qupath_json``:
    one rectangle feature per patch, classification name + a stable
    tab20 color per class index.
    """
    class_colours = tab20_colours(class_dict)

    features = []
    patch_coords = np.asarray(patch_coords)
    for i in range(patch_coords.shape[0]):
        class_idx = int(preds[i])
        class_name = class_dict[class_idx]
        geometry = Polygon.from_bounds(*patch_coords[i]).to_geojson_dict()
        features.append(
            {
                "type": "Feature",
                "id": f"patch_{i}",
                "geometry": geometry,
                "properties": {
                    "classification": {
                        "name": class_name,
                        "color": class_colours[class_idx],
                    }
                },
                "objectType": "annotation",
                "name": class_name,
            }
        )
    return {"type": "FeatureCollection", "features": features}


def store_to_qupath_json(store_or_instances, save_path: Path) -> Path:
    """Write annotations as QuPath-compatible GeoJSON features."""
    if hasattr(store_or_instances, "items"):
        items = store_or_instances.items()
    else:
        items = store_or_instances
    features = []
    for _key, ann in items:
        feature = ann.to_feature()
        props = feature.get("properties") or {}
        classification = {"name": str(props.get("type", "annotation"))}
        feature["properties"] = {
            "objectType": "annotation",
            "classification": classification,
            **props,
        }
        features.append(feature)
    Path(save_path).write_text(
        json.dumps({"type": "FeatureCollection", "features": features})
    )
    return Path(save_path)
