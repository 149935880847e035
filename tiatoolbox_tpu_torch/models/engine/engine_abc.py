"""Abstract inference engine (counterpart of ``tiatoolbox_tpu/models/engine/engine_abc.py``).

Resolve the model and ioconfig, plan the patch grid, stream batches through
the model on the device, post-process and return the outputs. Ported:
``EngineABC.run`` (:475), ``get_dataloader`` (:216), ``infer_patches``
(:255) with its bounded window of unfetched device outputs, ``infer_wsi``
(:346), ``argmax_probabilities`` (:526), and the outputs:
``prepare_engines_save_dir`` (:31-45), ``save_predictions`` (:362-412: dict,
zarr, an SQLite ``AnnotationStore`` or QuPath JSON of the patch
predictions), ``_calculate_scale_factor`` (:417-429, baseline over read
resolution, so store coordinates are at baseline), and ``_run_wsi_mode``'s
output names, ``<slide stem><suffix>`` (:442-473). ``infer_patches``
keeps a ``StageTimer`` in ``stages`` after each run: the batch loader's
"decode" (tile prefetch and patch reads, with "prefetch", the native tile
decode, inside it) and "wire" (the copy to the device), and "infer", the
whole loop.
"""

from __future__ import annotations

import shutil
import time
from abc import ABC
from collections import deque
from pathlib import Path
from typing import TypedDict

import numpy as np

from tiatoolbox_tpu_torch import DuplicateFilter, logger, resolve_device
from tiatoolbox_tpu_torch.models.dataset import PatchDataset, WSIPatchDataset
from tiatoolbox_tpu_torch.models.engine.io_config import ModelIOConfigABC
from tiatoolbox_tpu_torch.models.models_abc import ModelABC
from tiatoolbox_tpu_torch.parallel import BatchLoader
from tiatoolbox_tpu_torch.utils.profiling import StageTimer

# output file suffix of a slide's result, by output type (JAX :455-461)
OUTPUT_SUFFIXES = {
    "zarr": ".zarr",
    "annotationstore": ".db",
    "qupath": ".json",
    "ome-tiff": ".ome.tiff",
    "ome_tiff": ".ome.tiff",
}


def prepare_engines_save_dir(save_dir, *, patch_mode: bool, overwrite: bool = False) -> Path | None:  # noqa: ARG001
    """Create the engine's output directory, or refuse an existing one unless
    ``overwrite`` (JAX :31-45); None without a ``save_dir``."""
    if save_dir is None:
        return None
    save_dir = Path(save_dir)
    if save_dir.exists() and not overwrite:
        msg = f"save_dir already exists: {save_dir}. Set overwrite=True."
        raise FileExistsError(msg)
    if save_dir.exists() and overwrite:
        shutil.rmtree(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    return save_dir


class EngineABCRunParams(TypedDict, total=False):
    """Keyword arguments ``EngineABC.run`` takes (JAX ``engine_abc.py:60-65``, with keys).

    JAX's ``output_type`` is ``run``'s own argument here, and its
    ``transfer_threads`` (the relay link's threads) has no counterpart.
    """

    batch_size: int
    num_loader_workers: int
    resolution: float
    units: str
    patch_input_shape: tuple
    stride_shape: tuple
    min_mask_ratio: float
    auto_get_mask: bool
    return_labels: bool
    scale_factor: tuple
    class_dict: dict
    verbose: bool
    device: str
    num_workers: int
    output_file: str
    wsireader_kwargs: dict
    max_inflight_batches: int


class EngineABC(ABC):
    """Base engine: model resolution, run loop and outputs.

    Args:
        model: Registry name or a ``ModelABC``.
        weights: Optional local checkpoint: a ``.pth``/``.tar`` ``state_dict``
            or a flax ``.npz``.
        batch_size: Fixed device batch size.
        num_loader_workers: Host reader threads.
        device: Where the model runs; ``rcParam["device"]`` by default.
        verbose: Log progress.
    """

    def __init__(
        self,
        model,
        weights=None,
        batch_size: int = 32,
        num_loader_workers: int = 8,
        device: str | None = None,
        *,
        verbose: bool = True,
    ) -> None:
        self._ioconfig = None
        self.model, self.ioconfig = self._initialize_model_ioconfig(model, weights, device)
        self.batch_size = batch_size
        self.num_loader_workers = num_loader_workers
        self.device = device
        self.verbose = verbose
        self.stages: dict[str, dict] = {}
        self.images = None
        self.masks = None
        self.labels = None
        self.patch_mode = True
        self.resolution = None
        self.units = None
        self.patch_input_shape = None
        self.stride_shape = None
        self.min_mask_ratio = 0.0
        self.auto_get_mask = True
        self.return_labels = False
        self.output_type = "dict"
        self.scale_factor = (1.0, 1.0)
        self.class_dict: dict | None = None
        self.output_file: str | None = None
        self.wsireader_kwargs: dict = {}
        # Device outputs left unfetched while later batches are dispatched;
        # bounds device memory to O(window) batch outputs.
        self.max_inflight_batches = 8

    @staticmethod
    def _initialize_model_ioconfig(model, weights, device):
        """A registry name or ``ModelABC`` -> (model, ioconfig or None)."""
        if isinstance(model, str):
            from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model

            return get_pretrained_model(model, weights, device)
        if isinstance(model, ModelABC):
            if weights is not None:
                from tiatoolbox_tpu_torch.models.architecture import load_weights

                load_weights(model, weights)
            return model, None
        msg = "`model` must be a registry name or a ModelABC instance."
        raise TypeError(msg)

    _RUN_PARAMS = tuple(EngineABCRunParams.__annotations__)

    def _update_run_params(self, **kwargs) -> None:
        for key, value in kwargs.items():
            if key not in self._RUN_PARAMS:
                msg = f"Unknown run parameter: {key}"
                raise TypeError(msg)
            if key == "num_workers":
                key = "num_loader_workers"
            setattr(self, key, value)

    def _update_ioconfig(self, ioconfig) -> ModelIOConfigABC:
        """Merge explicit run params over the model's registry ioconfig."""
        if ioconfig is not None:
            self._ioconfig = ioconfig
        elif self.ioconfig is not None:
            self._ioconfig = self.ioconfig
        elif self.patch_input_shape is not None:
            self._ioconfig = ModelIOConfigABC(
                input_resolutions=[
                    {
                        "units": self.units or "baseline",
                        "resolution": self.resolution if self.resolution is not None else 1.0,
                    }
                ],
                patch_input_shape=tuple(self.patch_input_shape),
                stride_shape=(
                    tuple(self.stride_shape) if self.stride_shape is not None else None
                ),
                output_resolutions=[],
            )
        else:
            msg = (
                "Must provide either `ioconfig` or `patch_input_shape` "
                "(+ resolution/units) to run the engine."
            )
            raise ValueError(msg)
        if self.patch_input_shape is not None:
            self._ioconfig.patch_input_shape = tuple(self.patch_input_shape)
        if self.stride_shape is not None:
            self._ioconfig.stride_shape = tuple(self.stride_shape)
        if self.resolution is not None and self.units is not None:
            self._ioconfig.input_resolutions = [
                {"units": self.units, "resolution": self.resolution}
            ]
            self._ioconfig.__post_init__()
        return self._ioconfig

    def get_dataloader(
        self,
        images,
        masks=None,
        labels=None,
        ioconfig: ModelIOConfigABC | None = None,
        *,
        patch_mode: bool = True,
    ) -> BatchLoader:
        """A ``BatchLoader`` over patches or over a slide's patch grid."""
        if patch_mode:
            dataset = PatchDataset(inputs=images, labels=labels)
            dataset.preproc_func = self.model.preproc_func
        else:
            ioconfig = ioconfig or self._ioconfig
            resolution_dict = ioconfig.highest_input_resolution
            patch_shape_wh = tuple(int(v) for v in np.array(ioconfig.patch_input_shape)[::-1])
            stride_wh = tuple(int(v) for v in np.array(ioconfig.stride_shape)[::-1])
            dataset = WSIPatchDataset(
                img_path=images,
                mode="wsi",
                mask_path=masks,
                patch_input_shape=patch_shape_wh,
                stride_shape=stride_wh,
                resolution=resolution_dict["resolution"],
                units=resolution_dict["units"],
                min_mask_ratio=self.min_mask_ratio,
                preproc_func=self.model.preproc_func,
                auto_get_mask=self.auto_get_mask,
                wsireader_kwargs=self.wsireader_kwargs,
            )
        return BatchLoader(
            dataset, batch_size=self.batch_size, num_workers=self.num_loader_workers
        )

    def infer_patches(self, dataloader: BatchLoader, *, return_coordinates: bool = False) -> dict:
        """Stream batches through the model; gather host outputs in order.

        A model with several heads (HoVerNet's np, hv, tp) gives a list of
        per-head arrays under ``"probabilities"`` (:300-318).
        """

        def _fetch(out, n: int):
            if isinstance(out, (tuple, list)):
                return tuple(head[:n].cpu().numpy() for head in out)
            return out[:n].cpu().numpy()

        window = max(1, int(self.max_inflight_batches))
        inflight: deque = deque()
        probabilities, coordinates, labels = [], [], []
        n_total = 0
        timer = StageTimer()
        dataloader.timer = timer
        t_start = time.perf_counter()
        pin = self.model.device.type == "cuda"
        for batch in dataloader.iter_staged(self.model.stage_batch, pin_memory=pin):
            n_valid = batch["n_valid"]
            # dispatch without a sync: the next batch's read and copy overlap
            # this batch's forward (``run`` has put the model on its device)
            out = self.model.infer_batch_device(self.model, batch["image"])
            inflight.append((out, n_valid))
            if len(inflight) > window:
                probabilities.append(_fetch(*inflight.popleft()))
            n_total += n_valid
            if return_coordinates:
                if "coords" in batch:
                    coordinates.append(batch["coords"][:n_valid])
                else:
                    h, w = int(batch["image"].shape[1]), int(batch["image"].shape[2])
                    coordinates.append(np.tile([0, 0, w, h], (n_valid, 1)))
            if self.return_labels and "label" in batch:
                labels.append(np.asarray(batch["label"])[:n_valid])
        while inflight:
            probabilities.append(_fetch(*inflight.popleft()))
        timer.add("infer", time.perf_counter() - t_start, items=n_total)
        self.stages = timer.summary()
        if self.verbose:
            logger.info("infer: %d patches, stages %s", n_total, self.stages)
        if probabilities and isinstance(probabilities[0], tuple):  # one array per head
            output = {
                "probabilities": [
                    np.concatenate([p[head] for p in probabilities], axis=0)
                    for head in range(len(probabilities[0]))
                ]
            }
        else:
            output = {"probabilities": np.concatenate(probabilities, axis=0)}
        if coordinates:
            output["coordinates"] = np.concatenate(coordinates, axis=0)
        if labels:
            output["labels"] = np.concatenate(labels, axis=0)
        return output

    def infer_wsi(self, dataloader: BatchLoader) -> dict:
        """WSI-mode inference: patch inference with coordinates."""
        return self.infer_patches(dataloader, return_coordinates=True)

    def post_process_patches(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Hook: transform raw patch outputs (default passthrough)."""
        return raw_predictions

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Hook: transform raw WSI outputs (default passthrough)."""
        return raw_predictions

    def save_predictions(
        self,
        processed_predictions: dict,
        output_type: str,
        save_dir: Path | None = None,
        output_file: str | None = None,
        **kwargs,
    ):
        """Return the dict, or write it as zarr, an AnnotationStore ``.db`` or
        QuPath JSON under ``save_dir`` and return the path (:362-412).

        ``scale_factor`` (keyword) maps patch coordinates to baseline for the
        store; ``class_dict`` names the classes.
        """
        kind = output_type.lower()
        if save_dir is None and kind != "dict":
            msg = f"`save_dir` must be provided for output_type={output_type}."
            raise ValueError(msg)
        if kind == "dict":
            return processed_predictions
        if kind == "zarr":
            from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup

            out_path = Path(save_dir) / (output_file or "output.zarr")
            group = ZarrGroup.create(out_path)
            for key, value in processed_predictions.items():
                arr = np.asarray(value)
                if arr.dtype == object:
                    arr = arr.astype("U")
                if arr.dtype.kind in "USO":
                    group.attrs = {**group.attrs, key: arr.tolist()}
                else:
                    group.from_array(key, arr)
            return out_path
        if kind in ("annotationstore", "qupath"):
            from tiatoolbox_tpu_torch.utils.store_conversion import (
                dict_to_store_patch_predictions,
                store_to_qupath_json,
            )

            scale_factor = kwargs.get("scale_factor", self.scale_factor)
            if kind == "qupath":
                store = dict_to_store_patch_predictions(
                    processed_predictions, scale_factor=scale_factor, class_dict=self.class_dict
                )
                return store_to_qupath_json(store, Path(save_dir) / (output_file or "output.json"))
            return dict_to_store_patch_predictions(
                processed_predictions,
                scale_factor=scale_factor,
                class_dict=self.class_dict,
                save_path=Path(save_dir) / (output_file or "output.db"),
            )
        msg = f"Unsupported output_type: {output_type}"
        raise ValueError(msg)

    def _calculate_scale_factor(self, dataloader: BatchLoader) -> tuple[float, float]:
        """Baseline over read resolution, for store coordinates (:417-429)."""
        dataset = dataloader.dataset
        if not isinstance(dataset, WSIPatchDataset):
            return (1.0, 1.0)
        reader = dataset.reader
        baseline_wh = np.array(reader.info.slide_dimensions, dtype=float)
        read_wh = np.array(reader.slide_dimensions(dataset.resolution, dataset.units), dtype=float)
        return tuple(baseline_wh / read_wh)

    def _run_patch_mode(self, output_type: str, save_dir: Path | None, **kwargs):
        dataloader = self.get_dataloader(images=self.images, labels=self.labels, patch_mode=True)
        # a store needs each patch's box (:436)
        need_coords = output_type.lower() in ("annotationstore", "qupath")
        processed = self.post_process_patches(
            self.infer_patches(dataloader, return_coordinates=need_coords)
        )
        return self.save_predictions(
            processed, output_type, save_dir, output_file=self.output_file, **kwargs
        )

    def _run_wsi_mode(self, output_type: str, save_dir: Path | None, **kwargs):
        results = {}
        masks = self.masks if self.masks is not None else [None] * len(self.images)
        suffix = OUTPUT_SUFFIXES.get(output_type.lower(), "")
        for idx, image in enumerate(self.images):
            dataloader = self.get_dataloader(
                images=image, masks=masks[idx], ioconfig=self._ioconfig, patch_mode=False
            )
            scale_factor = self._calculate_scale_factor(dataloader)
            processed = self.post_process_wsi(self.infer_wsi(dataloader))
            output_file = self.output_file or (f"{Path(str(image)).stem}{suffix}" if suffix else None)
            results[str(image)] = self.save_predictions(
                processed,
                output_type,
                save_dir,
                output_file=output_file,
                scale_factor=scale_factor,
                **kwargs,
            )
        return results

    def run(
        self,
        images,
        masks=None,
        labels=None,
        ioconfig: ModelIOConfigABC | None = None,
        *,
        patch_mode: bool = True,
        save_dir=None,
        overwrite: bool = False,
        output_type: str = "dict",
        **kwargs,
    ):
        """Run inference on patches (``patch_mode``) or whole slides.

        Args:
            images: NHWC array / list of patches (patch mode) or list of
                slide paths (WSI mode).
            masks: Per-slide masks (WSI mode).
            labels: Per-patch labels (patch mode, returned with ``return_labels``).
            ioconfig: Override I/O config.
            patch_mode: Patch batches or whole slides.
            save_dir: Output directory, needed for every output but "dict".
            overwrite: Replace an existing ``save_dir``.
            output_type: "dict", "zarr", "annotationstore" or "qupath"
                ("ome-tiff" too for the semantic segmentor).
            **kwargs: Run-parameter overrides (batch_size, device, ...).

        Returns:
            Patch mode: the dict, or the written path. WSI mode: {slide: the
            dict, or the path of ``<slide stem><suffix>`` under ``save_dir``}.
        """
        dup_filter = DuplicateFilter()
        logger.addFilter(dup_filter)
        try:
            self._update_run_params(**kwargs)
            self.output_type = output_type
            self.images = images
            self.masks = masks
            self.labels = labels
            self.patch_mode = patch_mode
            save_dir = prepare_engines_save_dir(save_dir, patch_mode=patch_mode, overwrite=overwrite)
            self.model.to(resolve_device(self.device))
            if not patch_mode:
                self._update_ioconfig(ioconfig)
                return self._run_wsi_mode(output_type, save_dir)
            if self.ioconfig is None and ioconfig is not None:
                self._ioconfig = ioconfig
            return self._run_patch_mode(output_type, save_dir)
        finally:
            logger.removeFilter(dup_filter)


def argmax_probabilities(probabilities: np.ndarray) -> np.ndarray:
    """Class predictions from probabilities."""
    return np.argmax(probabilities, axis=-1)
