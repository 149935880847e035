"""Patch-grid planning (counterpart of ``tiatoolbox_tpu/tools/patchextraction.py``).

The parts ``WSIPatchDataset`` uses: ``PatchExtractor.get_coordinates``
(:239), the integer grid math every engine coordinate depends on, and
``PatchExtractor.filter_coordinates`` (:190), the tissue-mask selection.
Both are copied as they are.
"""

from __future__ import annotations

import numpy as np

from tiatoolbox_tpu_torch.wsicore import wsireader


def validate_shape(shape: np.ndarray) -> bool:
    """True when a shape array is invalid (non-positive or wrong ndim)."""
    return (
        not np.issubdtype(shape.dtype, np.integer)
        or shape.size != 2
        or np.any(shape < 0)
    )


class PatchExtractor:
    """Grid planning for patch extraction (``patchextraction.py:62``)."""

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
