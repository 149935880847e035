"""Normalized whole-slide-image metadata.

Copy of ``tiatoolbox_tpu/wsicore/wsimeta.py`` (``WSIMeta``, :19-179). The
``relative_level_scales`` resolution algebra is the contract every reader
and the tiling layer build on, so it is reproduced line for line.
"""

from __future__ import annotations

from numbers import Number
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import logger


class WSIMeta:
    """Normalized WSI metadata.

    Attributes:
        slide_dimensions: (width, height) of the baseline level.
        axes: Axes ordering string, e.g. "YXS".
        level_dimensions: (width, height) per pyramid level.
        level_downsamples: Scale of each level relative to baseline.
        level_count: Number of pyramid levels.
        objective_power: Objective magnification, if known.
        mpp: Microns per pixel (x, y) at baseline, if known.
        vendor: Scanner vendor string.
        file_path: Source file path.
        raw: Unprocessed format-specific metadata.
    """

    _valid_axes_characters = "YXSTZ"

    def __init__(
        self,
        slide_dimensions: tuple[int, int],
        axes: str,
        level_dimensions=None,
        objective_power: float | None = None,
        level_count: int | None = None,
        level_downsamples=(1,),
        vendor: str | None = None,
        mpp=None,
        file_path: Path | None = None,
        raw: dict | None = None,
    ) -> None:
        self.axes = axes
        self.objective_power = float(objective_power) if objective_power else None
        self.slide_dimensions = tuple(int(x) for x in slide_dimensions)
        self.level_dimensions = (
            tuple((int(w), int(h)) for w, h in level_dimensions)
            if level_dimensions is not None
            else [self.slide_dimensions]
        )
        self.level_downsamples = (
            [float(x) for x in level_downsamples]
            if level_downsamples is not None
            else [1.0]
        )
        self.level_count = (
            int(level_count) if level_count is not None else len(self.level_dimensions)
        )
        self.vendor = str(vendor)
        self.mpp = np.array([float(x) for x in mpp]) if mpp is not None else None
        self.file_path = Path(file_path) if file_path is not None else None
        self.raw = raw if raw is not None else None
        self.validate()

    def validate(self) -> bool:
        """Check metadata consistency; warn (never raise) on problems."""
        passed = True
        if set(self.axes) - set(self._valid_axes_characters):
            logger.warning(
                "Axes contains invalid characters. Valid characters are %s.",
                self._valid_axes_characters,
            )
            passed = False
        if self.level_count < 1:
            logger.warning("Level count is not a positive integer.")
            passed = False
        if self.level_dimensions is None:
            logger.warning("'level_dimensions' is None.")
            passed = False
        elif len(self.level_dimensions) != self.level_count:
            logger.warning("Length of level dimensions != level count")
            passed = False
        if self.level_downsamples is None:
            logger.warning("Level downsamples is None.")
            passed = False
        elif len(self.level_downsamples) != self.level_count:
            logger.warning("Length of level downsamples != level count")
            passed = False
        if self.raw is None:
            logger.warning("Raw data is None.")
        if all(x is None for x in (self.objective_power, self.mpp)):
            logger.warning("Unknown scale (no objective_power or mpp)")
        return passed

    def level_downsample(self, level: float) -> float:
        """Downsample factor for a level; fractional levels interpolate."""
        if isinstance(level, int) or int(level) == level:
            return self.level_downsamples[int(level)]
        floor = int(np.floor(level))
        ceil = int(np.ceil(level))
        return float(
            np.interp(
                level,
                [floor, ceil],
                [self.level_downsamples[floor], self.level_downsamples[ceil]],
            ),
        )

    def relative_level_scales(self, resolution, units: str) -> list[np.ndarray]:
        """Scale of each pyramid level relative to the given resolution.

        Values > 1 mean the level is at a larger scale (finer) than the
        target. Units: "mpp", "power", "level", "baseline".
        """
        if units not in ("mpp", "power", "level", "baseline"):
            msg = "Invalid units"
            raise ValueError(msg)

        def np_pair(x) -> np.ndarray:
            if isinstance(x, Number):
                return np.array([x] * 2)
            return np.array(x)

        if units == "level":
            if resolution >= len(self.level_downsamples):
                msg = (
                    f"Target scale level {resolution} > "
                    f"number of levels {len(self.level_downsamples)} in WSI"
                )
                raise ValueError(msg)
            resolution_array = np.array(
                [self.level_downsample(resolution)] * 2, dtype=float
            )
            base_scale = np.array([1.0, 1.0])
        elif units == "mpp":
            if self.mpp is None:
                msg = "MPP is None. Cannot determine scale in terms of MPP."
                raise ValueError(msg)
            base_scale = self.mpp
            resolution_array = np_pair(resolution)
        elif units == "power":
            if self.objective_power is None:
                msg = (
                    "Objective power is None. "
                    "Cannot determine scale in terms of objective power."
                )
                raise ValueError(msg)
            base_scale = np.array([1 / self.objective_power] * 2)
            resolution_array = 1.0 / np_pair(resolution)
        else:  # baseline
            base_scale = np.array([1.0, 1.0])
            resolution_array = 1.0 / np_pair(resolution)

        return [
            (base_scale * downsample) / resolution_array
            for downsample in self.level_downsamples
        ]

    def as_dict(self) -> dict:
        """Convert metadata to a plain dict."""
        mpp = (self.mpp, self.mpp) if self.mpp is None else tuple(self.mpp)
        return {
            "objective_power": self.objective_power,
            "slide_dimensions": self.slide_dimensions,
            "level_count": self.level_count,
            "level_dimensions": self.level_dimensions,
            "level_downsamples": self.level_downsamples,
            "vendor": self.vendor,
            "mpp": mpp,
            "file_path": self.file_path,
            "axes": self.axes,
        }
