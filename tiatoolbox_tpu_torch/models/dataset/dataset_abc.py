"""Patch datasets (counterpart of ``tiatoolbox_tpu/models/dataset/dataset_abc.py``).

``PatchDataset`` (:64) serves in-memory patches. ``WSIPatchDataset`` (:89)
plans the patch grid at the ioconfig resolution, filters it by a tissue
mask, and serves fixed-shape uint8 patches by index; its ``prefetch``
(:223-244) decodes the JPEG tiles of a batch of grid cells in one threaded
native call before the reads. Both are copied; image files other than
slides are not read (the port carries no image codec for them).
"""

from __future__ import annotations

from abc import ABC

import numpy as np

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.tools.patchextraction import PatchExtractor
from tiatoolbox_tpu_torch.wsicore.wsireader import VirtualWSIReader, WSIReader


class PatchDatasetABC(ABC):
    """Base: indexable dataset of uint8 patches with a preproc hook."""

    def __init__(self) -> None:
        super().__init__()
        self.preproc_func = None
        self.inputs = []
        self.labels = []

    @staticmethod
    def _check_input_integrity(mode: str, inputs) -> None:
        if mode == "patch":
            if isinstance(inputs, np.ndarray):
                if inputs.ndim != 4:
                    msg = "The shape of numpy array should be NHWC."
                    raise ValueError(msg)
            elif not isinstance(inputs, (list, tuple)):
                msg = "Input must be an NHWC array or list of patches/paths."
                raise ValueError(msg)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """Default preprocessing: identity (reference API)."""
        return image

    def _preproc(self, patch: np.ndarray) -> np.ndarray:
        if self.preproc_func is not None:
            return self.preproc_func(patch)
        return patch

    def __len__(self) -> int:
        return len(self.inputs)

    def __getitem__(self, idx: int) -> dict:
        raise NotImplementedError


class PatchDataset(PatchDatasetABC):
    """In-memory (or path-list) patch dataset.

    Args:
        inputs: NHWC uint8 array, or list of HWC arrays.
        labels: Optional per-patch labels.
    """

    def __init__(self, inputs, labels=None) -> None:
        super().__init__()
        self._check_input_integrity("patch", inputs)
        self.inputs = inputs
        self.labels = labels if labels is not None else []

    def __getitem__(self, idx: int) -> dict:
        patch = self._preproc(np.asarray(self.inputs[idx]))
        data = {"image": patch}
        if len(self.labels) > 0:
            data["label"] = self.labels[idx]
        return data


class WSIPatchDataset(PatchDatasetABC):
    """Grid-of-patches view over a WSI at a fixed resolution.

    Args:
        img_path: Path/array/reader for the slide.
        mode: "wsi" or "tile" (tile treats flat images as level 0).
        mask_path: Mask (path/array/reader), "otsu"/"morphological", or
            None for no filtering.
        patch_input_shape: (width, height) of served patches at
            ``resolution``/``units``.
        stride_shape: Grid stride (defaults to patch shape).
        resolution / units: Read resolution.
        min_mask_ratio: Minimum in-mask fraction for a grid cell.
        auto_get_mask: Auto-generate a tissue mask when none is given.
        patch_output_shape: Output-head grid (segmentors); produces the
            ``outputs`` coordinate list alongside ``inputs``.
    """

    def __init__(
        self,
        img_path,
        mode: str = "wsi",
        mask_path=None,
        patch_input_shape=None,
        stride_shape=None,
        resolution=None,
        units: str = None,
        min_mask_ratio: float = 0,
        preproc_func=None,
        patch_output_shape=None,
        wsireader_kwargs: dict | None = None,
        *,
        auto_get_mask: bool = True,
    ) -> None:
        super().__init__()
        if mode not in ("wsi", "tile"):
            msg = f"`{mode}` is not supported."
            raise ValueError(msg)
        patch_input_shape = np.array(patch_input_shape)
        if stride_shape is None:
            stride_shape = patch_input_shape
        stride_shape = np.array(stride_shape)
        if (
            not np.issubdtype(patch_input_shape.dtype, np.integer)
            or np.size(patch_input_shape) > 2
            or np.any(patch_input_shape < 0)
        ):
            msg = f"Invalid `patch_input_shape` value {patch_input_shape}."
            raise ValueError(msg)
        if (
            not np.issubdtype(stride_shape.dtype, np.integer)
            or np.size(stride_shape) > 2
            or np.any(stride_shape < 0)
        ):
            msg = f"Invalid `stride_shape` value {stride_shape}."
            raise ValueError(msg)

        self.preproc_func = preproc_func
        self.mode = mode
        self.resolution = resolution
        self.units = units
        self.patch_input_shape = tuple(int(v) for v in patch_input_shape)
        self.stride_shape = tuple(int(v) for v in stride_shape)

        if mode == "wsi":
            self.reader = WSIReader.open(img_path, **(wsireader_kwargs or {}))
        else:
            if not isinstance(img_path, np.ndarray):
                msg = "Tile mode reads an ndarray."
                raise TypeError(msg)
            self.reader = VirtualWSIReader(img_path)
            self.resolution = 1.0
            self.units = "baseline"

        wsi_shape = self.reader.slide_dimensions(self.resolution, self.units)

        if patch_output_shape is None:
            self.inputs = PatchExtractor.get_coordinates(
                image_shape=wsi_shape,
                patch_input_shape=self.patch_input_shape,
                stride_shape=self.stride_shape,
            )
            self.outputs = self.inputs
        else:
            self.inputs, self.outputs = PatchExtractor.get_coordinates(
                patch_output_shape=tuple(int(v) for v in np.array(patch_output_shape)),
                image_shape=wsi_shape,
                patch_input_shape=self.patch_input_shape,
                stride_shape=self.stride_shape,
            )
        self.full_inputs = self.inputs
        self.full_outputs = self.outputs

        mask_reader = self._setup_mask_reader(mask_path, auto_get_mask=auto_get_mask)
        if mask_reader is not None:
            selected = PatchExtractor.filter_coordinates(
                mask_reader,
                self.full_outputs,
                wsi_shape=wsi_shape,
                min_mask_ratio=min_mask_ratio,
            )
            self.inputs = self.full_inputs[selected]
            self.outputs = self.full_outputs[selected]

        if len(self.inputs) == 0:
            msg = "No patch coordinates remain after filtering."
            raise ValueError(msg)

    def _setup_mask_reader(self, mask_path, *, auto_get_mask: bool):
        if isinstance(mask_path, VirtualWSIReader):
            return mask_path
        if isinstance(mask_path, np.ndarray):
            return VirtualWSIReader(
                mask_path.astype(np.uint8), info=self.reader.info, mode="bool"
            )
        if str(mask_path) in ("otsu", "morphological"):
            if self.mode == "wsi":
                return self.reader.tissue_mask(
                    method=str(mask_path), resolution=1.25, units="power"
                )
            return None
        if mask_path is not None:
            msg = "mask_path must be an array, a VirtualWSIReader, 'otsu' or 'morphological'."
            raise TypeError(msg)
        if mask_path is None and auto_get_mask and self.mode == "wsi":
            try:
                return self.reader.tissue_mask(method="otsu", resolution=1.25, units="power")
            except (ValueError,) as exc:
                logger.warning("Auto tissue mask failed (%s); using full grid.", exc)
                return None
        return None

    def prefetch(self, indices) -> None:
        """Decode the tiles that the grid cells ``indices`` will read, in one
        native batch. Readers without the hook (not TIFF) ignore it; a tile
        that cannot be decoded raises here, as its read would."""
        hook = getattr(self.reader, "prefetch_bounds", None)
        if hook is None:
            return
        bounds = [
            self.reader.bounds_at_resolution_to_baseline(
                np.asarray(self.inputs[idx], float), self.resolution, self.units
            )
            for idx in indices
        ]
        hook(bounds, self.resolution, self.units)

    def __getitem__(self, idx: int) -> dict:
        coords = self.inputs[idx]
        bounds_size = coords[2:] - coords[:2]
        patch = self.reader.read_rect(
            location=(int(coords[0]), int(coords[1])),
            size=(int(bounds_size[0]), int(bounds_size[1])),
            resolution=self.resolution,
            units=self.units,
            coord_space="resolution",
        )
        patch = self._preproc(patch)
        return {"image": patch, "coords": np.array(coords)}
