"""Nucleus detection engine (counterpart of ``tiatoolbox_tpu/models/engine/nucleus_detector.py:1-244``).

``NucleusDetector`` is the semantic engine (``semantic_segmentor.py``) over a
detector's centroid maps (MapDe, SCCNN): the maps are stitched into a
canvas on the card (K2, per patch: both models have a host ``preproc`` of
their own, so the region feed is refused) and leave it normalised (K3).
Peaks are then found on the host: local maxima above a threshold
(``peak_detection_map_overlap``), then greedy NMS (``nms_on_detection_maps``),
per channel. A slide's canvas is read in row bands of 4096 rows (or
``postproc_tile_shape[0]``) with 32 rows of overlap on each side, and each
band keeps the detections whose row lies in its own rows (:62-91), so a
canvas spilled to zarr is read band by band as one in RAM is.

``save_predictions`` writes the detections as a point AnnotationStore,
zarr arrays (``coordinates``, ``scores``, ``types``) or, where JAX returns
the dict, QuPath JSON; ``make_points``, ``save_detection_arrays_to_store``
and ``save_detection_arrays_to_qupath_json`` are JAX's helpers (:176-244).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch.models.architecture.utils import (
    nms_on_detection_maps,
    peak_detection_map_overlap,
)
from tiatoolbox_tpu_torch.models.engine.semantic_segmentor import SemanticSegmentor, SemanticSegmentorRunParams

BAND_ROWS = 4096
BAND_OVERLAP = 32


class NucleusDetectorRunParams(SemanticSegmentorRunParams, total=False):
    """``NucleusDetector.run`` keyword arguments (JAX ``nucleus_detector.py:21-24``, with keys)."""

    min_distance: int
    threshold_abs: float
    threshold_rel: float
    postproc_tile_shape: tuple


class NucleusDetector(SemanticSegmentor):
    """Detection engine for MapDe and SCCNN centroid maps.

    Run parameters add ``min_distance``, ``threshold_abs``, ``threshold_rel``
    and ``postproc_tile_shape``. The peak detector takes the run's value,
    else the model's registry attribute, else 6 pixels and 0.5
    (``nucleus_detector.py:28-33``); ``threshold_rel`` raises the threshold
    to that share of each band's maximum.
    """

    _RUN_PARAMS = tuple(NucleusDetectorRunParams.__annotations__)

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.min_distance: int | None = None
        self.threshold_abs: float | None = None
        self.threshold_rel: float | None = None
        self.postproc_tile_shape: tuple[int, int] | None = None

    def post_process_patches(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Each patch's detections under ``"detections"`` (:50)."""
        maps = np.asarray(raw_predictions["probabilities"])
        out = dict(raw_predictions)
        out["detections"] = [self._detect(patch_map) for patch_map in maps]
        return out

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """The stitched map's detections in slide coordinates, band by band (:60)."""
        canvas = raw_predictions["probabilities"]
        h = canvas.shape[0]
        tile = int(self.postproc_tile_shape[0]) if self.postproc_tile_shape else BAND_ROWS
        all_coords, all_scores, all_types = [], [], []
        for y0 in range(0, h, tile):
            ry0 = max(y0 - BAND_OVERLAP, 0)
            ry1 = min(y0 + tile + BAND_OVERLAP, h)
            det = self._detect(np.asarray(canvas[ry0:ry1]))
            rows = det["coordinates"][:, 1] + ry0
            keep = (rows >= y0) & (rows < min(y0 + tile, h))
            coords = det["coordinates"][keep]
            coords[:, 1] += ry0
            all_coords.append(coords)
            all_scores.append(det["scores"][keep])
            all_types.append(det["types"][keep])
        return {
            "coordinates": np.concatenate(all_coords) if all_coords else np.zeros((0, 2)),
            "scores": np.concatenate(all_scores) if all_scores else np.zeros(0),
            "types": np.concatenate(all_types) if all_types else np.zeros(0, int),
        }

    def _detect(self, prob_map: np.ndarray) -> dict:
        """Peaks and NMS of each channel of an HWC map -> (x, y) detections (:94)."""
        min_distance = (
            self.min_distance if self.min_distance is not None else getattr(self.model, "min_distance", 6)
        )
        threshold_abs = (
            self.threshold_abs if self.threshold_abs is not None else getattr(self.model, "threshold_abs", 0.5)
        )
        if prob_map.ndim == 2:
            prob_map = prob_map[:, :, None]
        coords_list, scores_list, types_list = [], [], []
        for c in range(prob_map.shape[-1]):
            threshold = threshold_abs
            if self.threshold_rel is not None:
                threshold = max(threshold, float(prob_map[..., c].max()) * self.threshold_rel)
            peaks = peak_detection_map_overlap(prob_map[..., c], min_distance=min_distance, threshold_abs=threshold)
            if not len(peaks):
                continue
            scores = prob_map[peaks[:, 0], peaks[:, 1], c]
            keep = nms_on_detection_maps(peaks, scores, radius=min_distance)
            coords_list.append(peaks[keep][:, ::-1])  # (row, col) -> (x, y)
            scores_list.append(scores[keep])
            types_list.append(np.full(len(keep), c, dtype=int))
        if not coords_list:
            return {"coordinates": np.zeros((0, 2), int), "scores": np.zeros(0), "types": np.zeros(0, int)}
        return {
            "coordinates": np.concatenate(coords_list),
            "scores": np.concatenate(scores_list),
            "types": np.concatenate(types_list),
        }

    def save_predictions(
        self,
        processed_predictions: dict,
        output_type: str,
        save_dir=None,
        output_file: str | None = None,
        **kwargs,
    ):
        """Return the dict, or write a point AnnotationStore, zarr arrays or
        QuPath JSON under ``save_dir`` and return the path (:143-174).

        JAX returns the dict for "qupath"; the port writes the QuPath JSON of
        the same points, as its semantic engine does.
        """
        kind = output_type.lower()
        if kind not in ("annotationstore", "zarr", "qupath"):
            return processed_predictions
        if save_dir is None:
            msg = f"`save_dir` must be provided for output_type={output_type}."
            raise ValueError(msg)
        scale_factor = kwargs.get("scale_factor", (1.0, 1.0))
        class_dict = getattr(self.model, "class_dict", None) or self.class_dict
        if kind == "annotationstore":
            return save_detection_arrays_to_store(
                processed_predictions,
                scale_factor=scale_factor,
                class_dict=class_dict,
                save_path=Path(save_dir) / (output_file or "output.db"),
            )
        if kind == "qupath":
            return save_detection_arrays_to_qupath_json(
                processed_predictions,
                scale_factor=scale_factor,
                class_dict=class_dict,
                save_path=Path(save_dir) / (output_file or "output.json"),
            )
        from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup

        out_path = Path(save_dir) / (output_file or "output.zarr")
        group = ZarrGroup.create(out_path)
        for key in ("coordinates", "scores", "types"):
            if key in processed_predictions:
                group.from_array(key, np.asarray(processed_predictions[key]))
        return out_path


def make_points(xs_batch: np.ndarray, ys_batch: np.ndarray) -> list:
    """(x, y) arrays -> Point geometries (:176)."""
    from tiatoolbox_tpu_torch.annotation.geometry import Point

    return [Point(float(x), float(y)) for x, y in zip(xs_batch, ys_batch)]


def save_detection_arrays_to_store(
    detection_arrays: dict,
    scale_factor=(1.0, 1.0),
    class_dict: dict | None = None,
    save_path=None,
    batch_size: int = 5000,  # noqa: ARG001 - JAX's signature
):
    """Detection arrays -> point AnnotationStore (:183)."""
    from tiatoolbox_tpu_torch.utils.store_conversion import dict_to_store_nucleus_detector

    return dict_to_store_nucleus_detector(
        detection_arrays, scale_factor=scale_factor, class_dict=class_dict, save_path=save_path
    )


def save_detection_arrays_to_qupath_json(
    detection_arrays: dict,
    scale_factor=(1.0, 1.0),
    class_dict: dict | None = None,
    save_path=None,
):
    """Detection arrays -> QuPath point FeatureCollection; written to
    ``save_path`` with a ``.json`` suffix when one is given (:201)."""
    coords = np.asarray(detection_arrays["coordinates"], dtype=float) * np.asarray(scale_factor, dtype=float)
    scores = detection_arrays.get("scores")
    types = detection_arrays.get("types")
    features = []
    for i, (x, y) in enumerate(coords):
        properties: dict = {"object_type": "detection"}
        if types is not None:
            type_value = types[i]
            name = class_dict.get(int(type_value), type_value) if class_dict else type_value
            properties["classification"] = {"name": str(name)}
        if scores is not None:
            properties["measurements"] = [{"name": "probability", "value": float(scores[i])}]
        features.append(
            {
                "type": "Feature",
                "geometry": {"type": "Point", "coordinates": [float(x), float(y)]},
                "properties": properties,
            }
        )
    collection = {"type": "FeatureCollection", "features": features}
    if save_path is not None:
        save_path = Path(save_path).with_suffix(".json")
        save_path.write_text(json.dumps(collection, indent=2))
        return save_path
    return collection
