"""Model I/O configuration (counterpart of ``tiatoolbox_tpu/models/engine/io_config.py``).

``ModelIOConfigABC`` (:16, with ``scale_to_highest`` :62 and
``to_baseline`` :77), ``IOPatchPredictorConfig`` (:108),
``IOSegmentorConfig`` (:113-125) and ``IOInstanceSegmentorConfig``
(:127-130), copied: resolution lists per input/output
head, patch and stride shapes, the highest-input-resolution selection, and
for segmentation the output patch shape, save resolution and tile shape, and
for instance segmentation the tile margin.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


@dataclass
class ModelIOConfigABC:
    """I/O information for a model: resolutions and patch geometry.

    Args:
        input_resolutions: One ``{"units": ..., "resolution": ...}``
            dict per model input head.
        patch_input_shape: (height, width) of the model input patch.
        stride_shape: (x, y) stride for patch extraction (defaults to
            patch_input_shape).
        output_resolutions: One resolution dict per output head.
    """

    input_resolutions: list
    patch_input_shape: tuple | list | np.ndarray = None
    stride_shape: tuple | list | np.ndarray = None
    output_resolutions: list = field(default_factory=list)
    ignore_index: int | None = None

    def __post_init__(self) -> None:
        if self.stride_shape is None:
            self.stride_shape = self.patch_input_shape
        self.resolution_unit = self.input_resolutions[0]["units"]
        if self.resolution_unit == "mpp":
            self.highest_input_resolution = min(
                self.input_resolutions, key=lambda x: x["resolution"]
            )
        else:
            self.highest_input_resolution = max(
                self.input_resolutions, key=lambda x: x["resolution"]
            )
        self._validate()

    def _validate(self) -> None:
        resolutions = self.input_resolutions + self.output_resolutions
        units = {v["units"] for v in resolutions}
        if len(units) != 1:
            msg = (
                f"Multiple resolution units found: `{units}`. "
                f"Mixing resolution units is not allowed."
            )
            raise ValueError(msg)
        if units.pop() not in ("power", "baseline", "mpp"):
            msg = f"Invalid resolution units `{units}`."
            raise ValueError(msg)

    @staticmethod
    def scale_to_highest(resolutions: list, units: str) -> np.ndarray:
        """Scale factor of each resolution relative to the highest one."""
        old_vals = [v["resolution"] for v in resolutions]
        if units not in ("baseline", "mpp", "power"):
            msg = (
                f"Unknown units `{units}`. Units should be one of "
                f"'baseline', 'mpp' or 'power'."
            )
            raise ValueError(msg)
        if units == "baseline":
            return np.array(old_vals)
        if units == "mpp":
            return np.min(old_vals) / np.array(old_vals)
        return np.array(old_vals) / np.max(old_vals)

    def to_baseline(self) -> "ModelIOConfigABC":
        """New config with resolutions converted to baseline units."""
        resolutions = self.input_resolutions + self.output_resolutions
        save_resolution = getattr(self, "save_resolution", None)
        if save_resolution is not None:
            resolutions = [*resolutions, save_resolution]
        scale_factors = self.scale_to_highest(resolutions, self.resolution_unit)
        n_in = len(self.input_resolutions)
        n_out = len(self.output_resolutions)
        input_resolutions = [
            {"units": "baseline", "resolution": float(v)}
            for v in scale_factors[:n_in]
        ]
        output_resolutions = [
            {"units": "baseline", "resolution": float(v)}
            for v in scale_factors[n_in : n_in + n_out]
        ]
        new = replace(
            self,
            input_resolutions=input_resolutions,
            output_resolutions=output_resolutions,
        )
        if save_resolution is not None:
            new.save_resolution = {
                "units": "baseline",
                "resolution": float(scale_factors[-1]),
            }
        return new


@dataclass
class IOPatchPredictorConfig(ModelIOConfigABC):
    """I/O config for patch prediction (reference ``io_config.py:326``)."""


@dataclass
class IOSegmentorConfig(ModelIOConfigABC):
    """I/O config for segmentation; adds output patch shape + save resolution."""

    patch_output_shape: tuple | list | np.ndarray = None
    save_resolution: dict | None = None
    tile_shape: tuple | list | np.ndarray = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.patch_output_shape is None:
            self.patch_output_shape = self.patch_input_shape


@dataclass
class IOInstanceSegmentorConfig(IOSegmentorConfig):
    """I/O config for instance segmentation; adds the tile margin geometry."""

    margin: int = None
