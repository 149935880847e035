"""Region-read helpers on arrays (counterpart of ``tiatoolbox_tpu/utils/image.py``).

Copied from ``tiatoolbox_tpu/utils/image.py:26-420``: the padding and
overlap algebra, ``conv_out_size`` (:50), ``crop_and_pad_edges`` (:96),
``safe_padded_read`` (:129) and ``sub_pixel_read``, which
``VirtualWSIReader`` reads through. Resampling goes through the port's ``imresize``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.utils.transforms import (
    bounds2locsize,
    bounds2slices,
    imresize,
    locsize2bounds,
    pad_bounds,
)

PADDING_TO_BOUNDS = np.array([-1, -1, 1, 1])


def normalize_padding_size(padding) -> np.ndarray:
    """Normalize padding to length-4 (left, top, right, bottom).

    Scalar → all sides; length-2 → (x, y) tiled.
    """
    if len(np.shape(padding)) > 1:
        msg = "Invalid input padding shape. Must be scalar or 1 dimensional."
        raise ValueError(msg)
    size = np.size(padding)
    if size not in (1, 2, 4):
        msg = f"Padding has invalid size {size}. Valid sizes are 1, 2, or 4."
        raise ValueError(msg)
    if size == 1:
        return np.repeat(padding, 4)
    if size == 2:
        return np.tile(padding, 2)
    return np.array(padding)


def conv_out_size(in_size, kernel_size=1, padding=0, stride=1) -> np.ndarray:
    """Convolution output-size formula (floor((n - k + 2p) / s) + 1)."""
    return (np.floor((in_size - kernel_size + 2 * padding) / stride) + 1).astype(int)


def find_padding(read_location, read_size, image_size) -> np.ndarray:
    """np.pad-style padding needed for a read at ``read_location``.

    Returns ((before_y, after_y), (before_x, after_x)) — i.e. in numpy
    axis order, matching reference ``image.py:77-116``.
    """
    loc = np.array(read_location)
    size = np.array(read_size)
    img = np.array(image_size)
    before = np.maximum(-loc, 0)
    end = loc + size
    after = np.maximum(end - np.max([img, loc], 0), 0)
    return np.stack([before[::-1], after[::-1]], axis=1)


def find_overlap(read_location, read_size, image_size) -> np.ndarray:
    """Bounds of the part of a read region inside the image area."""
    loc = np.array(read_location)
    size = np.array(read_size)
    img = np.array(image_size)
    start = np.maximum(loc, 0)
    stop = np.minimum(loc + size, img)
    return np.concatenate([start, stop])


def make_bounds_size_positive(bounds) -> tuple:
    """Swap coordinates so width/height are positive; return flip flags."""
    flip_lr, flip_ud = False, False
    _, (width, height) = bounds2locsize(bounds)
    if width >= 0 and height >= 0:
        return bounds, flip_lr, flip_ud
    left, top, right, bottom = bounds
    if width < 0:
        left, right = right, left
        flip_lr = True
    if height < 0:
        top, bottom = bottom, top
        flip_ud = True
    return np.array([left, top, right, bottom]), flip_lr, flip_ud


def crop_and_pad_edges(
    bounds,
    max_dimensions,
    region: np.ndarray,
    pad_mode: str | None = "constant",
    pad_constant_values=0,
) -> np.ndarray:
    """Crop a region to valid image area then pad back to requested size."""
    loc, size = bounds2locsize(bounds)
    if np.min(max_dimensions) < 0:
        msg = "Max dimensions must be >= 0."
        raise ValueError(msg)
    if np.min(size) <= 0:
        msg = "Bounds must have size (width and height) > 0."
        raise ValueError(msg)

    padding = find_padding(loc, size, max_dimensions)
    if region.ndim > 2:
        padding = np.concatenate([padding, [[0, 0]]])
    if np.all(padding == 0):
        return region

    overlap = find_overlap(loc, size, max_dimensions)
    overlap = np.maximum(overlap - np.tile(loc, 2), 0)
    crop = region[bounds2slices(overlap)]
    if pad_mode in ("none", None):
        return crop
    crop = np.array(crop)
    if pad_mode == "constant":
        return np.pad(crop, padding, mode="constant", constant_values=pad_constant_values)
    return np.pad(crop, padding, mode=pad_mode)


def safe_padded_read(
    image: np.ndarray,
    bounds,
    stride=1,
    padding=0,
    pad_mode: str | None = "constant",
    pad_constant_values=0,
    pad_kwargs: dict | None = None,
) -> np.ndarray:
    """Read integer bounds from an array, padding out-of-bounds areas.

    Same contract as reference ``image.py:298-444``: bounds may extend
    outside the image; the outside area is filled via np.pad with
    ``pad_mode`` (or cropped away when pad_mode is None/"none").
    """
    if pad_kwargs is None:
        pad_kwargs = {}
    if pad_mode == "constant" and "constant_values" not in pad_kwargs:
        pad_kwargs["constant_values"] = pad_constant_values

    if not issubclass(np.array(bounds).dtype.type, (int, np.integer)):
        msg = "Bounds must be integers."
        raise TypeError(msg)
    padding_array = np.array(padding)
    if np.any(padding_array < 0):
        msg = "Padding cannot be negative."
        raise ValueError(msg)
    padding_array = normalize_padding_size(padding_array)

    if np.size(stride) not in (1, 2):
        msg = "Stride must be of size 1 or 2."
        raise ValueError(msg)
    stride_arr = np.tile(stride, 2) if np.size(stride) == 1 else np.array(stride)
    x_stride, y_stride = stride_arr

    padded_bounds = bounds + (padding_array * PADDING_TO_BOUNDS)
    img_size = np.array(image.shape[:2][::-1])
    limits = np.tile(img_size, 2)
    over = padded_bounds >= limits
    under = padded_bounds < 0
    if not np.any(over | under):
        left, top, right, bottom = padded_bounds
        return image[top:bottom:y_stride, left:right:x_stride, ...]

    clamped = np.clip(padded_bounds, 0, limits)
    clamped = np.round(clamped).astype(int)
    left, top, right, bottom = clamped
    region = image[top:bottom:y_stride, left:right:x_stride, ...]

    if not np.all(np.isin(stride_arr, [None, 1])):
        bounds = conv_out_size(np.array(bounds), stride=np.tile(stride_arr, 2))
        padded_bounds = bounds + (padding_array * PADDING_TO_BOUNDS)
        img_size = conv_out_size(img_size, stride=stride_arr)

    if pad_mode in ("none", None):
        return region

    # Edge padding required to fill gaps between clamped and padded bounds.
    before = np.minimum([0, 0], padded_bounds[2:])
    after = np.maximum(img_size, padded_bounds[:2] - img_size)
    edge = padded_bounds - np.concatenate([before, after])
    edge[:2] = np.minimum(edge[:2], [0, 0])
    edge[2:] = np.maximum(edge[2:], [0, 0])
    edge = np.abs(edge)
    left, top, right, bottom = edge
    pad_width = [(top, bottom), (left, right)]
    if region.ndim == 3:
        pad_width += [(0, 0)]
    return np.pad(np.array(region), pad_width, mode=pad_mode or "constant", **pad_kwargs)


def sub_pixel_read(
    image: np.ndarray,
    bounds,
    output_size,
    padding=0,
    stride=1,
    interpolation: str = "nearest",
    interpolation_padding: int = 2,
    read_func: Callable | None = None,
    pad_mode: str | None = "constant",
    pad_constant_values=0,
    read_kwargs: dict | None = None,
    pad_kwargs: dict | None = None,
    *,
    pad_at_baseline: bool,
) -> np.ndarray:
    """Read a possibly-fractional bounds region and resample to output_size.

    Same contract as reference ``image.py:445-740``: expand fractional
    bounds to integers with ``interpolation_padding`` margin, read via
    ``read_func`` (default array slicing via safe bounds), pad
    out-of-image area, rescale, trim the interpolation margin, and
    enforce the output size.
    """
    if pad_kwargs is None:
        pad_kwargs = {}
    if read_kwargs is None:
        read_kwargs = {}
    if interpolation is None:
        interpolation = "none"
    if pad_mode == "constant" and "constant_values" not in pad_kwargs:
        pad_kwargs["constant_values"] = pad_constant_values

    if 0 in bounds2locsize(bounds)[1]:
        msg = "Bounds must have non-zero size"
        raise ValueError(msg)

    normalized_padding = normalize_padding_size(padding)

    # Fast path: an integer-aligned, unscaled, unpadded, fully-in-image
    # read is a plain slice. The general path below reduces to exactly
    # this (margin-expand → identity-resize → margin-trim), so the
    # result is bit-identical; this skips ~3 ms/patch of bounds algebra
    # and identity cv2.resize on the engines' aligned grid reads.
    if read_func is None and np.all(np.asarray(stride) == 1):
        b = np.asarray(bounds, dtype=np.float64)
        _, b_size = bounds2locsize(b)
        img_w, img_h = image.shape[1], image.shape[0]
        out_matches = (
            output_size is None
            or interpolation == "none"  # general path never resizes then
            or np.array_equal(np.asarray(output_size), b_size)
        )
        if (
            out_matches
            and np.all(b == np.floor(b))
            and np.all(b_size > 0)
            and np.all(normalized_padding == 0)
            and b[0] >= 0
            and b[1] >= 0
            and b[2] <= img_w
            and b[3] <= img_h
        ):
            x0, y0, x1, y1 = b.astype(int)
            return np.array(image[y0:y1, x0:x1])

    bounds, fliplr, flipud = make_bounds_size_positive(bounds)
    if fliplr or flipud:
        logger.warning("Bounds have a negative size, output will be flipped.")

    if pad_mode and str(pad_mode).lower() == "none":
        pad_mode = None

    image_size = np.flip(image.shape[:2])
    scaling = np.array([1, 1])
    _, bounds_size = bounds2locsize(bounds)
    if output_size is not None and interpolation != "none":
        scaling = np.array(output_size) / bounds_size / stride
    read_bounds = bounds
    if pad_mode is None:
        read_location, read_size = bounds2locsize(bounds)
        output_size = np.round(
            bounds2locsize(find_overlap(read_location, read_size, image_size))[1]
            * scaling,
        ).astype(int)

    read_location, read_size = bounds2locsize(bounds)
    overlap_bounds = find_overlap(read_location, read_size, image_size)
    if pad_mode is None:
        read_bounds = tuple(overlap_bounds)

    baseline_padding = normalized_padding
    if not pad_at_baseline:
        baseline_padding = normalized_padding * np.tile(scaling, 2)

    _, padded_size = bounds2locsize(pad_bounds(bounds, baseline_padding))
    if 0 in padded_size:
        msg = "Bounds have zero size after padding."
        raise ValueError(msg)

    read_bounds = pad_bounds(read_bounds, interpolation_padding + baseline_padding)
    # Expand to integer bounds, tracking fractional residuals.
    start, end = np.reshape(read_bounds, (2, -1))
    int_read_bounds = np.concatenate([np.floor(start), np.ceil(end)])
    residuals = np.abs(int_read_bounds - read_bounds)
    read_location, read_size = bounds2locsize(int_read_bounds)
    valid_int_bounds = find_overlap(read_location, read_size, image_size).astype(int)
    _, valid_int_size = bounds2locsize(valid_int_bounds)

    if read_func is None:
        region = image[bounds2slices(valid_int_bounds, stride=stride)]
    else:
        region = read_func(image, valid_int_bounds, stride, **read_kwargs)
        if region is None or 0 in region.shape:
            msg = "Read region is empty or None."
            raise ValueError(msg)
        if not np.array_equal(region.shape[:2][::-1], valid_int_size):
            msg = "Read function returned a region of incorrect size."
            raise ValueError(msg)
    region = np.array(region)

    # Pad out-of-image area.
    read_location, read_size = bounds2locsize(int_read_bounds)
    pad_width = find_padding(read_location, read_size, image_size)
    if pad_mode is None:
        ov_location, ov_size = bounds2locsize(overlap_bounds)
        pad_width -= find_padding(ov_location, ov_size, image_size)
    pad_width = pad_width / stride
    if image.ndim > 2:
        pad_width = np.concatenate([pad_width, [(0, 0)]])
    if pad_mode == "constant":
        region = np.pad(region, pad_width.astype(int), mode="constant", **pad_kwargs)
    else:
        region = np.pad(region, pad_width.astype(int), mode=pad_mode or "constant")

    # Rescale.
    if output_size is not None and interpolation != "none":
        region = imresize(region, scale_factor=tuple(scaling), interpolation=interpolation)

    # Trim interpolation margin (+ fractional residuals).
    region_wh = tuple(np.flip(region.shape[:2]))
    trimming = bounds2slices(
        np.round(
            pad_bounds(
                locsize2bounds((0, 0), region_wh),
                (-(interpolation_padding + residuals) * np.tile(scaling, 2)),
            ),
        ).astype(int),
    )
    region = region[trimming]
    region_wh = region.shape[:2][::-1]

    # Enforce exact output size.
    if output_size is not None and interpolation != "none":
        total_padding = normalized_padding.reshape(2, 2).sum(axis=0)
        if pad_at_baseline:
            output_size = np.round(np.add(output_size, total_padding * scaling)).astype(int)
        else:
            output_size = np.add(output_size, total_padding)
        if not np.array_equal(region_wh, output_size):
            region = imresize(region, output_size=tuple(output_size), interpolation=interpolation)

    if fliplr:
        region = np.fliplr(region)
    if flipud:
        region = np.flipud(region)
    return region
