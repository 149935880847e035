"""Abstract inference engine (counterpart of ``tiatoolbox_tpu/models/engine/engine_abc.py``).

Resolve the model and ioconfig, plan the patch grid, stream batches through
the model on the device, post-process and return the outputs. Ported:
``EngineABC.run`` (:475), ``get_dataloader`` (:216), ``infer_patches``
(:255) with its bounded window of unfetched device outputs, ``infer_wsi``
(:346) and ``argmax_probabilities`` (:526), for ``output_type="dict"``.
Zarr and annotation-store outputs are not ported yet.
"""

from __future__ import annotations

import time
from abc import ABC
from collections import deque

import numpy as np

from tiatoolbox_tpu_torch import DuplicateFilter, logger, resolve_device
from tiatoolbox_tpu_torch.models.dataset import PatchDataset, WSIPatchDataset
from tiatoolbox_tpu_torch.models.engine.io_config import ModelIOConfigABC
from tiatoolbox_tpu_torch.models.models_abc import ModelABC
from tiatoolbox_tpu_torch.parallel import BatchLoader


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

    _RUN_PARAMS = (
        "batch_size",
        "num_loader_workers",
        "resolution",
        "units",
        "patch_input_shape",
        "stride_shape",
        "min_mask_ratio",
        "auto_get_mask",
        "return_labels",
        "device",
        "num_workers",
        "wsireader_kwargs",
        "max_inflight_batches",
    )

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
        """Stream batches through the model; gather host outputs in order."""
        window = max(1, int(self.max_inflight_batches))
        inflight: deque = deque()
        probabilities, coordinates, labels = [], [], []
        n_total = 0
        t_start = time.perf_counter()
        pin = self.model.device.type == "cuda"
        for batch in dataloader.iter_staged(self.model.stage_batch, pin_memory=pin):
            n_valid = batch["n_valid"]
            # dispatch without a sync: the next batch's read and copy overlap
            # this batch's forward (``run`` has put the model on its device)
            out = self.model.infer_batch_device(self.model, batch["image"])
            inflight.append((out, n_valid))
            if len(inflight) > window:
                out, n = inflight.popleft()
                probabilities.append(out[:n].cpu().numpy())
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
            out, n = inflight.popleft()
            probabilities.append(out[:n].cpu().numpy())
        if self.verbose:
            seconds = time.perf_counter() - t_start
            logger.info("infer: %d patches in %.3f s", n_total, seconds)
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

    def _run_patch_mode(self) -> dict:
        dataloader = self.get_dataloader(
            images=self.images, labels=self.labels, patch_mode=True
        )
        return self.post_process_patches(self.infer_patches(dataloader))

    def _run_wsi_mode(self) -> dict:
        results = {}
        masks = self.masks if self.masks is not None else [None] * len(self.images)
        for idx, image in enumerate(self.images):
            dataloader = self.get_dataloader(
                images=image, masks=masks[idx], ioconfig=self._ioconfig, patch_mode=False
            )
            results[str(image)] = self.post_process_wsi(self.infer_wsi(dataloader))
        return results

    def run(
        self,
        images,
        masks=None,
        labels=None,
        ioconfig: ModelIOConfigABC | None = None,
        *,
        patch_mode: bool = True,
        output_type: str = "dict",
        **kwargs,
    ) -> dict:
        """Run inference on patches (``patch_mode``) or whole slides.

        Args:
            images: NHWC array / list of patches (patch mode) or list of
                slide paths (WSI mode).
            masks: Per-slide masks (WSI mode).
            labels: Per-patch labels (patch mode, returned with ``return_labels``).
            ioconfig: Override I/O config.
            patch_mode: Patch batches or whole slides.
            output_type: "dict" (the only output the port writes so far).
            **kwargs: Run-parameter overrides (batch_size, device, ...).

        Returns:
            Patch mode: dict of outputs. WSI mode: {slide: dict of outputs}.
        """
        if output_type.lower() != "dict":
            msg = f"Unsupported output_type: {output_type} (the port writes 'dict')."
            raise ValueError(msg)
        dup_filter = DuplicateFilter()
        logger.addFilter(dup_filter)
        try:
            self._update_run_params(**kwargs)
            self.output_type = output_type
            self.images = images
            self.masks = masks
            self.labels = labels
            self.patch_mode = patch_mode
            self.model.to(resolve_device(self.device))
            if not patch_mode:
                self._update_ioconfig(ioconfig)
                return self._run_wsi_mode()
            if self.ioconfig is None and ioconfig is not None:
                self._ioconfig = ioconfig
            return self._run_patch_mode()
        finally:
            logger.removeFilter(dup_filter)


def argmax_probabilities(probabilities: np.ndarray) -> np.ndarray:
    """Class predictions from probabilities."""
    return np.argmax(probabilities, axis=-1)
