"""Model I/O configuration (counterpart of ``tiatoolbox_tpu/models/engine/io_config.py``).

``ModelIOConfigABC`` (:16), ``IOPatchPredictorConfig`` (:108) and
``IOSegmentorConfig`` (:113-125), copied: resolution lists per input/output
head, patch and stride shapes, the highest-input-resolution selection, and
for segmentation the output patch shape, save resolution and tile shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
