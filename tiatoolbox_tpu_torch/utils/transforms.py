"""Host-side image transforms in NumPy (counterpart of ``tiatoolbox_tpu/utils/transforms.py``).

``rgb2od``/``od2rgb`` (:170-186) and the bounds helpers (:187-230) are
copied as they are. ``imresize`` (:110) is written without OpenCV:

- ``"area"`` shrinking by an integer factor reproduces OpenCV's
  ``INTER_AREA`` exactly for integer images (2x2 blocks round half up,
  other factors multiply the block sum by the float32 reciprocal of the
  block area and round half to even);
- ``"area"`` at other factors averages with exact overlap weights and
  rounds half to even, which may differ from OpenCV by one level;
- ``"nearest"`` reproduces ``INTER_NEAREST``;
- ``"linear"`` and ``"cubic"`` go through ``torch.nn.functional.interpolate``
  (half-pixel centres, the same cubic coefficient -0.75 as OpenCV) and may
  differ from OpenCV by rounding.
"""

from __future__ import annotations

import numpy as np
import torch

_INTERPOLATIONS = ("nearest", "linear", "area", "cubic")

# Working dtype for each source dtype (``transforms.py:99-108``).
_RESIZE_DTYPE_MAP: dict[np.dtype, np.dtype] = {
    np.dtype(np.bool_): np.dtype(np.uint8),
    np.dtype(np.int8): np.dtype(np.int16),
    np.dtype(np.int16): np.dtype(np.int16),
    np.dtype(np.int32): np.dtype(np.float32),
    np.dtype(np.uint8): np.dtype(np.uint8),
    np.dtype(np.uint16): np.dtype(np.uint16),
    np.dtype(np.uint32): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.float64),
    np.dtype(np.uint64): np.dtype(np.float64),
    np.dtype(np.float16): np.dtype(np.float32),
    np.dtype(np.float32): np.dtype(np.float32),
    np.dtype(np.float64): np.dtype(np.float64),
}


def background_composite(
    image: np.ndarray, fill: int = 255, *, alpha: bool = False
) -> np.ndarray:
    """Composite an RGBA image onto a constant background (``transforms.py:59-90``)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = img.astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 3:
        if alpha:
            out_a = np.full(img.shape[:2] + (1,), 255, np.uint8)
            return np.concatenate([img, out_a], axis=-1)
        return img.copy() if img is image else img
    rgb = img[..., :3].astype(np.float32)
    w = img[..., 3:4].astype(np.float32) / 255.0
    out_rgb = rgb * w + float(fill) * (1.0 - w)
    out_rgb = np.clip(np.rint(out_rgb), 0, 255).astype(np.uint8)
    if alpha:
        out_a = np.full(img.shape[:2] + (1,), 255, np.uint8)
        return np.concatenate([out_rgb, out_a], axis=-1)
    return out_rgb


def _to_dtype(values: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(values), info.min, info.max).astype(dtype)
    return values.astype(dtype)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] overlap weights of output cells over input pixels."""
    scale = n_in / n_out
    start = np.arange(n_out)[:, None] * scale
    stop = start + scale
    pix = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(stop, pix + 1) - np.maximum(start, pix), 0, None)
    return overlap / scale


def _resize_area(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    fx, fy = w / out_w, h / out_h
    if fx == int(fx) and fy == int(fy):
        fx, fy = int(fx), int(fy)
        blocks = img[: out_h * fy, : out_w * fx].reshape(
            out_h, fy, out_w, fx, *img.shape[2:]
        )
        if np.issubdtype(img.dtype, np.integer):
            total = blocks.sum(axis=(1, 3), dtype=np.int64)
            if fx == fy == 2:
                return ((total + 2) >> 2).astype(img.dtype)
            scaled = total.astype(np.float32) * np.float32(1.0 / (fx * fy))
            return _to_dtype(scaled, img.dtype)
        return blocks.mean(axis=(1, 3), dtype=np.float64).astype(img.dtype)
    wy = _area_weights(h, out_h)
    wx = _area_weights(w, out_w)
    # rows, then columns: O(output x input) work, where one three-operand
    # einsum loops over every (y, h, w, x) at once
    rows = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(wx, rows, axes=(1, 1)), 0, 1)
    return _to_dtype(out, img.dtype)


def _resize_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (h / out_h)).astype(int), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (w / out_w)).astype(int), w - 1)
    return img[ys][:, xs]


def _resize_torch(img: np.ndarray, out_w: int, out_h: int, mode: str) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float64))
    x = x[None, None] if img.ndim == 2 else x.permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(
        x, size=(out_h, out_w), mode=mode, align_corners=False
    )[0]
    out = y[0] if img.ndim == 2 else y.permute(1, 2, 0)
    return _to_dtype(out.numpy(), img.dtype)


def imresize(
    img: np.ndarray,
    scale_factor: float | tuple[float, float] | None = None,
    output_size: int | tuple[int, int] | None = None,
    interpolation: str = "optimise",
) -> np.ndarray:
    """Resize an HxW[xC] image by scale factor or to ``output_size`` (width, height).

    ``interpolation="optimise"`` takes ``"area"`` when shrinking and
    ``"cubic"`` when enlarging, as ``transforms.py:110-167`` does.
    """
    if scale_factor is None and output_size is None:
        msg = "One of scale_factor and output_size must be not None."
        raise TypeError(msg)
    sf = None
    if scale_factor is not None:
        sf = np.atleast_1d(np.asarray(scale_factor, dtype=float))
        if sf.size == 1:
            sf = np.repeat(sf, 2)
    if output_size is None:
        out_wh = np.array([int(img.shape[1] * sf[0]), int(img.shape[0] * sf[1])])
    else:
        out_wh = np.atleast_1d(np.asarray(output_size))
        if out_wh.size == 1:
            out_wh = np.repeat(out_wh, 2)
    if sf is None:
        sf = np.asarray(img.shape[:2][::-1], dtype=float) / out_wh
    if np.all(sf == 1.0):
        return img
    if interpolation == "optimise":
        interpolation = "cubic" if np.any(sf > 1.0) else "area"
    if interpolation not in _INTERPOLATIONS:
        msg = f"Invalid interpolation: {interpolation}"
        raise ValueError(msg)
    original_dtype = img.dtype
    if original_dtype not in _RESIZE_DTYPE_MAP:
        msg = f"Does not support resizing for array of dtype: {original_dtype}"
        raise ValueError(msg)
    img = img.astype(_RESIZE_DTYPE_MAP[original_dtype])
    out_w, out_h = int(out_wh[0]), int(out_wh[1])
    if img.shape[0] == img.shape[1] == 1:
        return img.repeat(out_h, 0).repeat(out_w, 1)
    if interpolation == "nearest":
        return _resize_nearest(img, out_w, out_h)
    if interpolation == "area" and out_w <= img.shape[1] and out_h <= img.shape[0]:
        return _resize_area(img, out_w, out_h)
    mode = "bicubic" if interpolation == "cubic" else "bilinear"
    return _resize_torch(img, out_w, out_h, mode)


def rgb2od(img: np.ndarray) -> np.ndarray:
    r"""RGB -> optical density :math:`OD = -\log(I/255)`, zeros mapped to 1 (``:170-179``)."""
    img = np.copy(img)
    img[img == 0] = 1
    return np.maximum(-1 * np.log(img / 255.0), 1e-6)


def od2rgb(od: np.ndarray) -> np.ndarray:
    """Optical density -> uint8 RGB (``:182-185``)."""
    od = np.maximum(od, 1e-6)
    return (255 * np.exp(-1 * od)).astype(np.uint8)


def bounds2locsize(bounds, origin: str = "upper") -> tuple[np.ndarray, np.ndarray]:
    """(left, top, right, bottom) bounds -> (location, size) arrays."""
    left, top, right, bottom = bounds
    origin = origin.lower()
    if origin == "upper":
        return np.array([left, top]), np.array([right - left, bottom - top])
    if origin == "lower":
        return np.array([left, bottom]), np.array([right - left, top - bottom])
    msg = "Invalid origin. Only 'upper' or 'lower' are valid."
    raise ValueError(msg)


def locsize2bounds(location, size) -> tuple:
    """(location, size) -> (left, top, right, bottom) bounds."""
    return (
        location[0],
        location[1],
        location[0] + size[0],
        location[1] + size[1],
    )


def bounds2slices(bounds, stride: int = 1) -> tuple[slice, ...]:
    """Bounds -> numpy slices in (y, x) read order."""
    if np.size(stride) not in (1, 2):
        msg = "Invalid stride shape."
        raise ValueError(msg)
    strides = np.tile(stride, 4 // max(np.size(stride), 1))[:2]
    start, stop = np.reshape(np.asarray(bounds), (2, -1)).astype(int)
    return tuple(
        slice(s, e, int(st)) for s, e, st in zip(start[::-1], stop[::-1], strides)
    )


def pad_bounds(bounds, padding) -> tuple:
    """Expand bounds outward by padding (scalar, per-axis, or per-edge)."""
    if np.size(bounds) % 2 != 0:
        msg = "Bounds must have an even number of elements."
        raise ValueError(msg)
    ndims = np.size(bounds) // 2
    if np.size(padding) not in (1, ndims, np.size(bounds)):
        msg = "Invalid number of padding elements."
        raise ValueError(msg)
    pad = np.asarray(padding)
    if pad.size == ndims:
        pad = np.tile(pad, 2)
    signs = np.repeat([-1, 1], ndims)
    return tuple(np.add(bounds, pad * signs))
