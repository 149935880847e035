"""Patch extraction (counterpart of ``tiatoolbox_tpu/tools/patchextraction.py``).

``PatchExtractor.get_coordinates`` (:239), the integer grid math every
engine coordinate depends on, and ``PatchExtractor.filter_coordinates``
(:190), the tissue-mask selection, are copied as they are. So are the
extractors built on them: ``PatchExtractor`` (:62-188: a slide or array,
an optional mask given as "otsu", "morphological", an ndarray, a ``.npy``
or JPEG path or a ``VirtualWSIReader``, iteration and indexing by read),
``SlidingWindowPatchExtractor`` (:319-353), ``PointsPatchExtractor``
(:356-386) and ``get_patch_extractor`` (:389-396). Point tables come from
``utils.misc.read_locations``, a numpy-backed table in place of JAX's
DataFrame.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import logger, native
from tiatoolbox_tpu_torch.utils import misc
from tiatoolbox_tpu_torch.wsicore import wsireader


class MethodNotSupportedError(Exception):
    """An extraction method the port does not know."""


class ExtractorParams(dict):
    """Keyword arguments accepted by ``get_patch_extractor``: input_img,
    locations_list, patch_size, resolution, units, pad_mode,
    pad_constant_values, within_bound, input_mask, min_mask_ratio, stride."""


class PointsPatchExtractorParams(ExtractorParams):
    """Keyword arguments for PointsPatchExtractor."""


class SlidingWindowPatchExtractorParams(ExtractorParams):
    """Keyword arguments for SlidingWindowPatchExtractor."""


def validate_shape(shape: np.ndarray) -> bool:
    """True when a shape array is invalid (non-positive or wrong ndim)."""
    return (
        not np.issubdtype(shape.dtype, np.integer)
        or shape.size != 2
        or np.any(shape < 0)
    )


class PatchExtractorABC(ABC):
    """Abstract base for patch extractors."""

    @abstractmethod
    def __iter__(self):
        raise NotImplementedError

    @abstractmethod
    def __next__(self):
        raise NotImplementedError

    @abstractmethod
    def __getitem__(self, item: int):
        raise NotImplementedError


def _read_mask_image(path) -> np.ndarray:
    """A mask file: ``.npy``, or a JPEG through the port's decoder (the JAX
    package's ``misc.imread`` reads every format cv2 reads)."""
    path = Path(path)
    if not path.is_file():
        msg = f"Could not find image file: {path}"
        raise FileNotFoundError(msg)
    if path.suffix.lower() == ".npy":
        return np.load(str(path))
    if path.suffix.lower() in (".jpg", ".jpeg"):
        image = native.decode_jpeg(path.read_bytes())
        return image[:, :, 0] if image.shape[2] == 1 else image
    msg = f"Mask files are read as .npy or JPEG here, not {path.suffix}."
    raise wsireader.FileNotSupportedError(msg)


class PatchExtractor(PatchExtractorABC):
    """Extract patches from an image/WSI on a coordinate grid.

    Args:
        input_img: Image path, ndarray, or WSIReader.
        patch_size: (width, height) of output patches.
        input_mask: Mask (path/ndarray/VirtualWSIReader) or "otsu"/
            "morphological" to auto-generate a tissue mask.
        resolution / units: Read resolution for patches.
        pad_mode / pad_constant_values: Edge padding behaviour.
        within_bound: Skip patches whose input bounds exceed the image.
        min_mask_ratio: Minimum positive-mask fraction per patch.
    """

    def __init__(
        self,
        input_img,
        patch_size,
        input_mask=None,
        resolution=0,
        units: str = "level",
        pad_mode: str = "constant",
        pad_constant_values=0,
        min_mask_ratio: float = 0,
        *,
        within_bound: bool = False,
    ) -> None:
        if isinstance(patch_size, (tuple, list, np.ndarray)):
            self.patch_size = (int(patch_size[0]), int(patch_size[1]))
        else:
            self.patch_size = (int(patch_size), int(patch_size))
        self.resolution = resolution
        self.units = units
        self.pad_mode = pad_mode
        self.pad_constant_values = pad_constant_values
        self.n = 0
        self.wsi = wsireader.WSIReader.open(input_img=input_img)
        self.locations_df: misc.LocationTable | None = None
        self.coordinate_list: np.ndarray | None = None
        self.stride: tuple[int, int] | None = None
        self.min_mask_ratio = min_mask_ratio

        if input_mask is None:
            self.mask = None
        elif isinstance(input_mask, str) and input_mask in ("otsu", "morphological"):
            if isinstance(self.wsi, wsireader.VirtualWSIReader):
                self.mask = None
            else:
                self.mask = self.wsi.tissue_mask(
                    method=input_mask, resolution=1.25, units="power"
                )
        elif isinstance(input_mask, wsireader.VirtualWSIReader):
            self.mask = input_mask
        elif isinstance(input_mask, (str, np.ndarray)) or hasattr(input_mask, "__fspath__"):
            mask_img = (
                input_mask
                if isinstance(input_mask, np.ndarray)
                else _read_mask_image(input_mask)
            )
            self.mask = wsireader.VirtualWSIReader(
                mask_img, info=self.wsi.info, mode="bool"
            )
        else:
            msg = "Unsupported input_mask type."
            raise TypeError(msg)
        self.within_bound = within_bound

    def __iter__(self):
        self.n = 0
        return self

    def __len__(self) -> int:
        return self.locations_df.shape[0] if self.locations_df is not None else 0

    def __next__(self) -> np.ndarray:
        n = self.n
        if n >= self.locations_df.shape[0]:
            raise StopIteration
        self.n = n + 1
        return self[n]

    def __getitem__(self, item: int) -> np.ndarray:
        if not isinstance(item, (int, np.integer)):
            msg = "Index should be an integer."
            raise TypeError(msg)
        if item >= self.locations_df.shape[0]:
            raise IndexError
        x = self.locations_df["x"][item]
        y = self.locations_df["y"][item]
        return self.wsi.read_rect(
            location=(int(x), int(y)),
            size=self.patch_size,
            resolution=self.resolution,
            units=self.units,
            pad_mode=self.pad_mode,
            pad_constant_values=self.pad_constant_values,
            coord_space="resolution",
        )

    def _generate_location_df(self) -> "PatchExtractor":
        """Build the coordinate grid, mask-filter it, store locations."""
        slide_dimension = self.wsi.slide_dimensions(self.resolution, self.units)
        self.coordinate_list = self.get_coordinates(
            patch_output_shape=None,
            image_shape=(slide_dimension[0], slide_dimension[1]),
            patch_input_shape=(self.patch_size[0], self.patch_size[1]),
            stride_shape=(self.stride[0], self.stride[1]),
            input_within_bound=self.within_bound,
        )
        if self.mask is not None:
            selected = self.filter_coordinates(
                self.mask,
                self.coordinate_list,
                wsi_shape=slide_dimension,
                min_mask_ratio=self.min_mask_ratio,
            )
            self.coordinate_list = self.coordinate_list[selected]
            if len(self.coordinate_list) == 0:
                logger.warning(
                    "No candidate coordinates left after filtering by "
                    "`input_mask` positions.",
                )
        data = self.coordinate_list[:, :2]
        self.locations_df = misc.read_locations(input_table=np.array(data))
        return self

    @staticmethod
    def filter_coordinates(
        mask_reader: "wsireader.VirtualWSIReader",
        coordinates_list: np.ndarray,
        wsi_shape: tuple[int, int],
        min_mask_ratio: float = 0,
        func=None,
    ) -> np.ndarray:
        """Flags for coordinates with enough positive mask coverage.

        Coordinates are bounding boxes [start_x, start_y, end_x, end_y]
        at the extraction resolution; they are scaled to the mask array
        resolution before area checks (reference ``:356-464``).
        """
        if not isinstance(mask_reader, wsireader.VirtualWSIReader):
            msg = "`mask_reader` should be wsireader.VirtualWSIReader."
            raise TypeError(msg)
        if not isinstance(coordinates_list, np.ndarray) or not np.issubdtype(
            coordinates_list.dtype, np.integer
        ):
            msg = "`coordinates_list` should be ndarray of integer type."
            raise ValueError(msg)
        if coordinates_list.shape[-1] != 4:
            msg = "`coordinates_list` must be of shape [N, 4]."
            raise ValueError(msg)
        if not 0 <= min_mask_ratio <= 1:
            msg = "`min_mask_ratio` must be between 0 and 1."
            raise ValueError(msg)

        tissue_mask = mask_reader.img
        scale_factors = np.array(tissue_mask.shape[1::-1]) / np.array(wsi_shape)
        scaled = coordinates_list.copy().astype(np.float32)
        scaled[:, [0, 2]] *= scale_factors[0]
        scaled[:, [0, 2]] = np.clip(scaled[:, [0, 2]], 0, tissue_mask.shape[1])
        scaled[:, [1, 3]] *= scale_factors[1]
        scaled[:, [1, 3]] = np.clip(scaled[:, [1, 3]], 0, tissue_mask.shape[0])
        scaled_list = scaled.astype(np.int32).tolist()

        def default_sel_func(mask: np.ndarray, coord) -> bool:
            part = mask[coord[1] : coord[3], coord[0] : coord[2]]
            patch_area = int(np.prod(part.shape))
            pos_area = int(np.count_nonzero(part))
            return (
                (pos_area == patch_area) or (pos_area > patch_area * min_mask_ratio)
            ) and (pos_area > 0 and patch_area > 0)

        func = default_sel_func if func is None else func
        return np.array([func(tissue_mask, coord) for coord in scaled_list])

    @staticmethod
    def get_coordinates(
        patch_output_shape=None,
        image_shape=None,
        patch_input_shape=None,
        stride_shape=None,
        *,
        input_within_bound: bool = False,
        output_within_bound: bool = False,
    ):
        """Patch tiling grid in [start_x, start_y, end_x, end_y] format.

        With ``patch_output_shape`` given, returns (input_bounds,
        output_bounds) with the input grid centred around the output
        grid — the exact integer math of reference ``:488-614``.
        """
        return_output_bound = patch_output_shape is not None
        image_shape_arr = np.array(image_shape)
        patch_input_shape_arr = np.array(patch_input_shape)
        if patch_output_shape is None:
            output_within_bound = False
            patch_output_shape_arr = patch_input_shape_arr
        else:
            patch_output_shape_arr = np.array(patch_output_shape)
        stride_shape_arr = np.array(stride_shape)

        for name, arr in (
            ("image_shape", image_shape_arr),
            ("patch_input_shape", patch_input_shape_arr),
            ("patch_output_shape", patch_output_shape_arr),
            ("stride_shape", stride_shape_arr),
        ):
            if validate_shape(arr):
                msg = f"Invalid `{name}` value {arr}."
                raise ValueError(msg)
        if np.any(patch_input_shape_arr < patch_output_shape_arr):
            msg = (
                f"`patch_input_shape` must larger than `patch_output_shape` "
                f"{patch_input_shape_arr} must > {patch_output_shape_arr}."
            )
            raise ValueError(msg)
        if np.any(stride_shape_arr < 1):
            msg = f"`stride_shape` value {stride_shape_arr} must > 1."
            raise ValueError(msg)

        def flat_mesh_grid_coord(x, y) -> np.ndarray:
            xv, yv = np.meshgrid(x, y)
            return np.stack([xv.flatten(), yv.flatten()], axis=-1)

        output_x_end = (
            np.ceil(image_shape_arr[0] / stride_shape_arr[0]) * stride_shape_arr[0]
        )
        output_x_list = np.arange(0, int(output_x_end), stride_shape_arr[0])
        output_y_end = (
            np.ceil(image_shape_arr[1] / stride_shape_arr[1]) * stride_shape_arr[1]
        )
        output_y_list = np.arange(0, int(output_y_end), stride_shape_arr[1])
        output_tl_list = flat_mesh_grid_coord(output_x_list, output_y_list)
        output_br_list = output_tl_list + patch_output_shape_arr[None]

        io_diff = patch_input_shape_arr - patch_output_shape_arr
        input_tl_list = output_tl_list - (io_diff // 2)[None]
        input_br_list = input_tl_list + patch_input_shape_arr[None]

        sel = np.zeros(input_tl_list.shape[0], dtype=bool)
        if output_within_bound:
            sel |= np.any(output_br_list > image_shape_arr[None], axis=1)
        if input_within_bound:
            sel |= np.any(input_br_list > image_shape_arr[None], axis=1)
            sel |= np.any(input_tl_list < 0, axis=1)
        input_bound_list = np.concatenate(
            [input_tl_list[~sel], input_br_list[~sel]], axis=-1
        )
        output_bound_list = np.concatenate(
            [output_tl_list[~sel], output_br_list[~sel]], axis=-1
        )
        if return_output_bound:
            return input_bound_list, output_bound_list
        return input_bound_list


class SlidingWindowPatchExtractor(PatchExtractor):
    """Grid extraction with a fixed stride (defaults to patch size)."""

    def __init__(
        self,
        input_img,
        patch_size,
        input_mask=None,
        resolution=0,
        units: str = "level",
        stride=None,
        pad_mode: str = "constant",
        pad_constant_values=0,
        min_mask_ratio: float = 0,
        *,
        within_bound: bool = False,
    ) -> None:
        super().__init__(
            input_img=input_img,
            input_mask=input_mask,
            patch_size=patch_size,
            resolution=resolution,
            units=units,
            pad_mode=pad_mode,
            pad_constant_values=pad_constant_values,
            within_bound=within_bound,
            min_mask_ratio=min_mask_ratio,
        )
        if stride is None:
            self.stride = self.patch_size
        elif isinstance(stride, (tuple, list, np.ndarray)):
            self.stride = (int(stride[0]), int(stride[1]))
        else:
            self.stride = (int(stride), int(stride))
        self._generate_location_df()


class PointsPatchExtractor(PatchExtractor):
    """Patches centred at given points (csv/json/npy/ndarray)."""

    def __init__(
        self,
        input_img,
        locations_list,
        patch_size=(224, 224),
        resolution=0,
        units: str = "level",
        pad_mode: str = "constant",
        pad_constant_values=0,
        *,
        within_bound: bool = False,
    ) -> None:
        super().__init__(
            input_img=input_img,
            patch_size=patch_size,
            resolution=resolution,
            units=units,
            pad_mode=pad_mode,
            pad_constant_values=pad_constant_values,
            within_bound=within_bound,
        )
        self.locations_df = misc.read_locations(input_table=locations_list)
        self.locations_df["x"] = self.locations_df["x"] - int(
            (self.patch_size[1] - 1) / 2
        )
        self.locations_df["y"] = self.locations_df["y"] - int(
            (self.patch_size[1] - 1) / 2
        )


def get_patch_extractor(method_name: str, **kwargs) -> PatchExtractor:
    """Factory: "slidingwindow" or "point" extractor."""
    if method_name.lower() not in ("slidingwindow", "point"):
        msg = f"{method_name.lower()} method is not currently supported."
        raise MethodNotSupportedError(msg)
    if method_name.lower() == "slidingwindow":
        return SlidingWindowPatchExtractor(**kwargs)
    return PointsPatchExtractor(**kwargs)
