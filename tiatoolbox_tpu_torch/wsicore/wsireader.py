"""Whole-slide image readers (counterpart of ``tiatoolbox_tpu/wsicore/wsireader.py``).

``WSIReader`` keeps the resolution algebra and the template ``read_rect``
(:414) / ``read_bounds`` (:479) over an in-bounds level read, plus
``slide_thumbnail`` and ``tissue_mask`` (:534). Concrete readers:

- ``VirtualWSIReader`` (:616): an ndarray as a slide, with virtual scaling;
- ``TIFFWSIReader`` (:783): tiled pyramidal TIFF through the port's ``tiffio``,
  with ``prefetch_bounds`` (:977-986), which decodes the JPEG tiles of many
  bounds in one threaded native batch.

Reads return RGB as stored: multiplex post-processing is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.utils.image import find_overlap, find_padding, sub_pixel_read
from tiatoolbox_tpu_torch.utils.misc import mpp2common_objective_power
from tiatoolbox_tpu_torch.utils.transforms import (
    background_composite,
    bounds2locsize,
    imresize,
    locsize2bounds,
)
from tiatoolbox_tpu_torch.wsicore.tiffio import TiffFile
from tiatoolbox_tpu_torch.wsicore.wsimeta import WSIMeta

_TIFF_MAGICS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


class FileNotSupportedError(Exception):
    """The file is not in a format the port reads."""


def _is_tiff(path: Path) -> bool:
    with path.open("rb") as fh:
        return fh.read(4) in _TIFF_MAGICS


class WSIReader:
    """Base whole-slide image reader.

    Args:
        input_img: Path to the slide or an ndarray.
        mpp: Override microns-per-pixel metadata (x, y).
        power: Override objective power metadata.
    """

    @staticmethod
    def open(input_img, mpp=None, power=None, **kwargs) -> "WSIReader":
        """Return a reader for an array, a reader, a TIFF file or a ``.npy`` file.

        Counterpart of ``wsireader.py:60-113`` for the formats the port reads.
        """
        if isinstance(input_img, np.ndarray):
            return VirtualWSIReader(input_img, mpp=mpp, power=power, **kwargs)
        if isinstance(input_img, WSIReader):
            return input_img
        path = Path(input_img)
        if not path.exists():
            msg = f"File does not exist: {path}"
            raise FileNotFoundError(msg)
        if path.suffix.lower() == ".npy":
            return VirtualWSIReader(np.load(str(path)), mpp=mpp, power=power, **kwargs)
        if path.is_file() and _is_tiff(path):
            return TIFFWSIReader(path, mpp=mpp, power=power)
        msg = f"File {path} is not a supported file format."
        raise FileNotSupportedError(msg)

    def __init__(self, input_img, mpp=None, power=None) -> None:
        if isinstance(input_img, (str, Path)):
            self.input_path: Path | None = Path(input_img)
        else:
            self.input_path = None
        self._m_info: WSIMeta | None = None
        self._manual_mpp = tuple(np.broadcast_to(mpp, 2).astype(float)) if mpp else None
        self._manual_power = float(power) if power else None

    # -- metadata --------------------------------------------------------------

    @property
    def info(self) -> WSIMeta:
        """Cached slide metadata, with manual mpp/power overrides applied."""
        if self._m_info is None:
            self._m_info = self._info()
            if self._manual_mpp:
                self._m_info.mpp = np.array(self._manual_mpp)
            if self._manual_power:
                self._m_info.objective_power = self._manual_power
        return self._m_info

    @info.setter
    def info(self, meta: WSIMeta) -> None:
        self._m_info = meta
        self._optlevel_cache = {}  # level search depends on the metadata

    def _info(self) -> WSIMeta:
        raise NotImplementedError

    # -- resolution algebra (contract identical to the reference) ---------------

    def _find_optimal_level_and_downsample(
        self, resolution, units, precision: int = 3
    ) -> tuple[int, np.ndarray]:
        """Most-downscaled level that is still >= the target resolution.

        Returns (level, post-read scale factor); reference
        ``wsireader.py:744-802``. Memoized per (resolution, units): grid
        readers (WSIPatchDataset) call this for every patch with
        identical arguments, and the level search dominated the warm
        read path before caching.
        """
        try:
            key = (
                tuple(np.atleast_1d(np.asarray(resolution, dtype=float))),
                units,
                precision,
            )
        except (TypeError, ValueError):
            key = None
        if key is not None:
            cache = getattr(self, "_optlevel_cache", None)
            if cache is None:
                cache = self._optlevel_cache = {}
            hit = cache.get(key)
            if hit is not None:
                return hit[0], hit[1].copy()
        level_scales = self.info.relative_level_scales(resolution, units)
        sufficient = [
            bool(np.all(np.round(x, decimals=precision) <= 1)) for x in level_scales
        ]
        if not any(sufficient):
            level = 0
        else:
            level = (len(level_scales) - 1) - int(np.argmax(sufficient[::-1]))
        scale = level_scales[level]
        if np.any(np.array(scale) > 1):
            logger.warning(
                "Read: Scale > 1. This means that the desired resolution is "
                "higher than the WSI baseline (maximum encoded resolution). "
                "Interpolation of read regions may occur.",
            )
        if key is not None:
            self._optlevel_cache[key] = (level, np.array(scale))
        return level, scale

    def find_read_rect_params(
        self, location, size, resolution, units, precision: int = 3
    ) -> tuple:
        """Optimal read level + coordinates for a read_rect call."""
        read_level, post_read_scale = self._find_optimal_level_and_downsample(
            resolution, units, precision
        )
        level_downsample = self.info.level_downsamples[read_level]
        baseline_read_size = np.round(
            np.array(size) * level_downsample / post_read_scale
        ).astype(int)
        level_read_size = np.round(np.array(size) / post_read_scale).astype(int)
        level_location = np.round(np.array(location) / level_downsample).astype(int)
        return (
            read_level,
            level_location,
            level_read_size,
            post_read_scale,
            baseline_read_size,
        )

    def _find_read_params_at_resolution(
        self, location, size, resolution, units
    ) -> tuple:
        """Read params when location/size are in the requested-resolution frame."""
        read_level, read_level_to_resolution = self._find_optimal_level_and_downsample(
            resolution, units
        )
        baseline_to_read_level = 1 / self.info.level_downsamples[read_level]
        baseline_to_resolution = baseline_to_read_level * read_level_to_resolution
        requested_location = np.array(location)
        requested_size = np.array(size)
        size_at_baseline = requested_size / baseline_to_resolution
        location_at_baseline = (
            requested_location.astype(np.float32) / baseline_to_resolution
        )
        size_at_read_level = requested_size / read_level_to_resolution
        location_at_read_level = (
            requested_location.astype(np.float32) / read_level_to_resolution
        )
        output = tuple(
            np.ceil(v).astype(np.int64)
            for v in (
                size_at_read_level,
                location_at_read_level,
                size_at_baseline,
                location_at_baseline,
            )
        )
        return (read_level, read_level_to_resolution, *output)

    def bounds_at_resolution_to_baseline(self, bounds, resolution, units):
        """Convert bounds given at requested resolution to baseline frame."""
        bounds = np.array(bounds)
        tl, br = bounds[:2], bounds[2:]
        size = br - tl
        (_, _, _, _, size_at_baseline, location_at_baseline) = (
            self._find_read_params_at_resolution(tl, size, resolution, units)
        )
        return np.concatenate(
            [location_at_baseline, location_at_baseline + size_at_baseline]
        )

    def slide_dimensions(self, resolution, units, precision: int = 3) -> tuple:
        """Slide (width, height) at the requested resolution."""
        baseline = self.info.slide_dimensions
        _, _, shape_at_resolution, _ = self.find_read_bounds_params(
            [0, 0, *list(baseline)], resolution, units, precision
        )
        return tuple(shape_at_resolution)

    def find_read_bounds_params(
        self, bounds, resolution, units, precision: int = 3
    ) -> tuple:
        """Optimal read level + level bounds + output size for read_bounds."""
        start_x, start_y, end_x, end_y = bounds
        read_level, post_read_scale = self._find_optimal_level_and_downsample(
            resolution, units, precision
        )
        level_downsample = self.info.level_downsamples[read_level]
        location = np.array([start_x, start_y])
        size = np.array([end_x - start_x, end_y - start_y])
        level_size = np.round(size / level_downsample).astype(int)
        level_location = np.round(location / level_downsample).astype(int)
        level_bounds = (*level_location, *(level_location + level_size))
        output_size = np.round(level_size * post_read_scale).astype(int)
        return (read_level, level_bounds, output_size, post_read_scale)

    # -- reading -----------------------------------------------------------------

    def _read_level_within(self, location, size, level: int) -> np.ndarray:
        """Read an in-bounds (clamped) region at a pyramid level.

        Concrete readers must implement this; location/size in level
        coordinates, guaranteed within the level image.
        """
        raise NotImplementedError

    def _read_level_bounds(
        self, bounds, level: int, pad_mode: str | None, pad_constant_values
    ) -> np.ndarray:
        """Read possibly out-of-bounds level bounds with edge padding."""
        loc, size = bounds2locsize(bounds)
        level_dims = self.info.level_dimensions[level]
        overlap = find_overlap(loc, size, level_dims)
        ov_loc, ov_size = bounds2locsize(overlap)
        if np.any(ov_size <= 0):
            n_ch = getattr(self, "_n_channels", 3)
            region = np.zeros((max(size[1], 0), max(size[0], 0), n_ch), dtype=np.uint8)
            if pad_mode == "constant" and not np.isscalar(pad_constant_values):
                region[...] = pad_constant_values
            elif pad_mode == "constant":
                region[...] = pad_constant_values
            return region
        region = self._read_level_within(ov_loc, ov_size, level)
        padding = find_padding(loc, size, level_dims)
        if np.all(padding == 0):
            return region
        if pad_mode in ("none", None):
            return region
        if region.ndim > 2:
            padding = np.concatenate([padding, [[0, 0]]])
        if pad_mode == "constant":
            return np.pad(
                region, padding, mode="constant", constant_values=pad_constant_values
            )
        return np.pad(region, padding, mode=pad_mode)

    def read_rect(
        self,
        location,
        size,
        resolution=0,
        units: str = "level",
        interpolation: str = "optimise",
        pad_mode: str = "constant",
        pad_constant_values=0,
        coord_space: str = "baseline",
        **kwargs,
    ) -> np.ndarray:
        """Read a region: location at baseline, size at output resolution.

        See reference ``wsireader.py:1360-1553`` for the full semantics;
        the field of view varies with resolution.
        """
        if coord_space == "resolution":
            return self.read_rect_at_resolution(
                location,
                size,
                resolution=resolution,
                units=units,
                interpolation=interpolation,
                pad_mode=pad_mode,
                pad_constant_values=pad_constant_values,
                **kwargs,
            )
        (read_level, level_location, level_read_size, _, _) = (
            self.find_read_rect_params(location, size, resolution, units)
        )
        bounds = locsize2bounds(level_location, level_read_size)
        region = self._read_level_bounds(
            bounds, read_level, pad_mode, pad_constant_values
        )
        if interpolation not in (None, "none"):
            region = imresize(
                region, output_size=tuple(np.array(size)), interpolation=interpolation
            )
        return np.ascontiguousarray(region)

    def read_rect_at_resolution(
        self,
        location,
        size,
        resolution=0,
        units: str = "level",
        **kwargs,
    ) -> np.ndarray:
        """read_rect with location/size in the requested-resolution frame."""
        tl = np.array(location)
        br = tl + np.array(size)
        bounds = np.concatenate([tl, br])
        return self.read_bounds(
            bounds,
            resolution=resolution,
            units=units,
            coord_space="resolution",
            **kwargs,
        )

    def read_bounds(
        self,
        bounds,
        resolution=0,
        units: str = "level",
        interpolation: str = "optimise",
        pad_mode: str = "constant",
        pad_constant_values=0,
        coord_space: str = "baseline",
        **kwargs,
    ) -> np.ndarray:
        """Read a baseline-frame bounds region; FOV fixed across resolutions."""
        bounds_at_baseline = bounds
        if coord_space == "resolution":
            bounds_at_baseline = self.bounds_at_resolution_to_baseline(
                bounds, resolution, units
            )
            _, size_at_requested = bounds2locsize(bounds)
            read_level, level_bounds, _, post_read_scale = (
                self.find_read_bounds_params(bounds_at_baseline, resolution, units)
            )
        else:
            read_level, level_bounds, size_at_requested, post_read_scale = (
                self.find_read_bounds_params(bounds_at_baseline, resolution, units)
            )
        region = self._read_level_bounds(
            level_bounds, read_level, pad_mode, pad_constant_values
        )
        if interpolation not in (None, "none"):
            region = imresize(
                region,
                output_size=tuple(np.array(size_at_requested)),
                interpolation=interpolation,
            )
        return region

    # -- conveniences -------------------------------------------------------------

    def slide_thumbnail(self, resolution=1.25, units: str = "power") -> np.ndarray:
        """Whole-slide thumbnail at the requested (low) resolution."""
        slide_dims = self.info.slide_dimensions
        bounds = [0, 0, *slide_dims]
        return self.read_bounds(bounds, resolution=resolution, units=units)

    def tissue_mask(
        self,
        method: str = "otsu",
        resolution=1.25,
        units: str = "power",
        **masker_kwargs,
    ) -> "VirtualWSIReader":
        """Compute a tissue mask and return it as a VirtualWSIReader."""
        from tiatoolbox_tpu_torch.tools import tissuemask

        thumbnail = self.slide_thumbnail(resolution, units)
        if method not in ("otsu", "morphological"):
            msg = f"Method {method} is not supported."
            raise ValueError(msg)
        if method == "morphological":
            mpp = None
            power = None
            if units == "mpp":
                mpp = resolution
            elif units == "power":
                power = resolution
            masker = tissuemask.MorphologicalMasker(
                mpp=mpp, power=power, **masker_kwargs
            )
        else:
            masker = tissuemask.OtsuTissueMasker(**masker_kwargs)
        mask_img = masker.fit_transform([thumbnail])[0]
        return VirtualWSIReader(mask_img.astype(np.uint8), info=self.info, mode="bool")


class VirtualWSIReader(WSIReader):
    """Array/flat-image reader with virtual pyramid scaling.

    ``mode`` is one of "rgb", "bool" (masks; nearest interpolation), or
    "feature" (arbitrary channels). A donor ``info`` WSIMeta rescales
    coordinates from the donor baseline onto this image.
    """

    def __init__(
        self,
        input_img,
        mpp=None,
        power=None,
        info: WSIMeta | None = None,
        mode: str = "rgb",
    ) -> None:
        super().__init__(input_img, mpp=mpp, power=power)
        if mode.lower() not in ("rgb", "bool", "feature"):
            msg = "Invalid mode."
            raise ValueError(msg)
        if not isinstance(input_img, np.ndarray):
            msg = "VirtualWSIReader reads an ndarray."
            raise TypeError(msg)
        self.img = input_img
        if self.img.ndim < 2:
            msg = "Input image must be 2D (H, W) or 3D (H, W, C)."
            raise ValueError(msg)
        if mode != "bool" and (self.img.ndim == 2 or self.img.shape[2] not in (3, 4)):
            logger.warning(
                "The image mode is set to 'feature' as the input dimensions do "
                "not match with binary mask or RGB/RGBA.",
            )
            mode = "feature"
        self.mode = mode.lower()
        if info is not None:
            self._m_info = info

    def _info(self) -> WSIMeta:
        return WSIMeta(
            file_path=self.input_path,
            axes="YXS",
            objective_power=None,
            slide_dimensions=self.img.shape[:2][::-1],
            level_count=1,
            level_dimensions=(self.img.shape[:2][::-1],),
            level_downsamples=[1.0],
            vendor=None,
            mpp=None,
            raw=None,
        )

    def _find_params_from_baseline(self, location, baseline_read_size):
        """Scale baseline coordinates onto this (possibly smaller) image."""
        baseline_size = np.array(self.info.slide_dimensions)
        image_size = np.array(self.img.shape[:2][::-1])
        size_ratio = image_size / baseline_size
        image_location = np.array(location, dtype=np.float32) * size_ratio
        read_size = np.array(baseline_read_size) * size_ratio
        return image_location, read_size

    def read_rect(
        self,
        location,
        size,
        resolution=0,
        units: str = "level",
        interpolation: str = "optimise",
        pad_mode: str = "constant",
        pad_constant_values=0,
        coord_space: str = "baseline",
        **kwargs,
    ) -> np.ndarray:
        if coord_space == "resolution":
            return self.read_rect_at_resolution(
                location,
                size,
                resolution=resolution,
                units=units,
                interpolation=interpolation,
                pad_mode=pad_mode,
                pad_constant_values=pad_constant_values,
            )
        (_, _, _, _, baseline_read_size) = self.find_read_rect_params(
            location, size, resolution, units
        )
        image_location, image_read_size = self._find_params_from_baseline(
            location, baseline_read_size
        )
        bounds = locsize2bounds(image_location, image_read_size)
        if interpolation == "optimise" and self.mode == "bool":
            interpolation = "nearest"
        output_size = None if interpolation in (None, "none") else size
        region = sub_pixel_read(
            self.img,
            bounds,
            output_size=output_size,
            interpolation=interpolation,
            pad_mode=pad_mode,
            pad_constant_values=pad_constant_values,
            read_kwargs=kwargs,
            pad_at_baseline=False,
        )
        if self.mode == "rgb":
            return background_composite(region, alpha=False)
        # contiguity contract: mask/feature modes can return slice
        # views of self.img — copy so callers can't mutate the backing
        # image (and C-order matches every other reader)
        return np.ascontiguousarray(region)

    def read_bounds(
        self,
        bounds,
        resolution=0,
        units: str = "level",
        interpolation: str = "optimise",
        pad_mode: str = "constant",
        pad_constant_values=0,
        coord_space: str = "baseline",
        **kwargs,
    ) -> np.ndarray:
        bounds_at_baseline = bounds
        if coord_space == "resolution":
            bounds_at_baseline = self.bounds_at_resolution_to_baseline(
                bounds, resolution, units
            )
            _, size_at_requested = bounds2locsize(bounds)
            _, _, _, post_read_scale = self.find_read_bounds_params(
                bounds_at_baseline, resolution=resolution, units=units
            )
        else:
            _, _, size_at_requested, post_read_scale = self.find_read_bounds_params(
                bounds_at_baseline, resolution=resolution, units=units
            )
        location_at_read, size_at_read = self._find_params_from_baseline(
            *bounds2locsize(bounds_at_baseline)
        )
        bounds_at_read = locsize2bounds(location_at_read, size_at_read)
        if interpolation in (None, "none"):
            interpolation = None
        if interpolation == "optimise" and self.mode == "bool":
            interpolation = "nearest"
        region = sub_pixel_read(
            self.img,
            bounds_at_read,
            output_size=size_at_requested,
            interpolation=interpolation,
            pad_mode=pad_mode,
            pad_constant_values=pad_constant_values,
            read_kwargs=kwargs,
            pad_at_baseline=False,
        )
        if coord_space == "resolution":
            region = imresize(region, output_size=size_at_requested)
        else:
            region = imresize(
                region, scale_factor=post_read_scale, output_size=size_at_requested
            )
        if self.mode == "rgb":
            return background_composite(region, alpha=False)
        return region


class TIFFWSIReader(WSIReader):
    """Tiled pyramidal TIFF / SVS / OME-TIFF reader on ``tiffio``."""

    def __init__(self, input_img, mpp=None, power=None) -> None:
        super().__init__(input_img, mpp=mpp, power=power)
        self.tiff = TiffFile(self.input_path)
        self._level_pages = self.tiff.pyramid_pages()
        if not self._level_pages:
            msg = f"No image pyramid found in {self.input_path}"
            raise FileNotSupportedError(msg)
        base = self.tiff.pages[self._level_pages[0]]
        self._n_channels = base.samples_per_pixel

    def _info(self) -> WSIMeta:
        pages = [self.tiff.pages[i] for i in self._level_pages]
        base = pages[0]
        level_dims = [(p.width, p.height) for p in pages]
        downsamples = [base.width / p.width for p in pages]
        meta = self.tiff.svs_metadata()
        mpp = meta["mpp"]
        objective_power = meta["objective_power"]
        if objective_power is None and mpp is not None:
            objective_power = float(mpp2common_objective_power(mpp[0]))
        return WSIMeta(
            file_path=self.input_path,
            axes="YXS",
            slide_dimensions=(base.width, base.height),
            level_dimensions=level_dims,
            level_downsamples=downsamples,
            level_count=len(pages),
            vendor=meta["vendor"],
            mpp=mpp,
            objective_power=objective_power,
            raw={"description": base.description},
        )

    def _read_level_within(self, location, size, level: int) -> np.ndarray:
        page_index = self._level_pages[level]
        return self.tiff.read_region(
            page_index, tuple(int(v) for v in location), tuple(int(v) for v in size)
        )

    def prefetch_bounds(self, bounds_list, resolution, units) -> None:
        """Decode every JPEG tile that the given baseline-frame bounds touch,
        in one threaded native batch (``TiffFile.prefetch_regions``), at the
        level that reads at ``resolution``; later reads hit the tile cache."""
        level, _scale = self._find_optimal_level_and_downsample(resolution, units)
        ds = self.info.level_downsamples[level]
        level_bounds = [tuple(np.asarray(b, float) / ds) for b in bounds_list]
        self.tiff.prefetch_regions(self._level_pages[level], level_bounds)
