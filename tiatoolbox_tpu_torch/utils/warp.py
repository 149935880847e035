"""OpenCV's bilinear geometry and box filter on the host, in numpy.

JAX's registration (``tiatoolbox_tpu/tools/registration/wsi_registration.py``)
and ``TransformedWSIReader`` (``wsicore/store_reader.py``) warp, resample
and smooth through ``cv2``, which the card machine does not have.
``prealignment`` picks the best of 36 rotations by the Dice score of a
warped mask, so those warps must be OpenCV's bit for bit, or the chosen
angle can differ. This module reproduces OpenCV 5.0 (x86-64, AVX-512
dispatch) as measured against it:

- ``warp_affine`` (``cv2.warpAffine``, ``INTER_LINEAR``, ``BORDER_CONSTANT``):
  for uint8 and float32 images OpenCV inverts the matrix in double, rounds
  it to float32 and interpolates in float32. The source position of a
  pixel is ``fma(x, m0, y * m1 + m2)`` in the columns its 16-wide vector
  loop covers and ``fma(x, m0, y * m1) + m2`` in the scalar tail; the two
  lerps run as fused multiply-adds, horizontally first; uint8 rounds half
  to even. A tap outside the image takes the border value; a pixel whose
  four taps are all outside is the border value. Float64 images take
  OpenCV's older fixed-point path: positions in 1/1024, quantised to
  1/32, weights from its float32 table, summed in double;
- ``remap_linear`` (``cv2.remap`` with float32 maps): the same
  interpolation at the map's positions (float64 images: positions rounded
  to 1/32);
- ``resize_linear`` (``cv2.resize``, ``INTER_LINEAR``): uint8 in OpenCV's
  11-bit fixed point (horizontal weights clamped at the edges, vertical
  ones not, and its ``(b0 * (S0 >> 4)) >> 16`` vertical pass); float32 and
  float64 as a lerp in double, within one float32 rounding (float32) and
  1e-13 (float64) of OpenCV on [0, 1] values, and 1e-5 from a source one
  pixel wide or high, where OpenCV's float paths differ; they are not
  reproduced bit for bit;
- ``box_blur`` (``cv2.blur``, ``BORDER_REFLECT_101``): uint8 from integer
  window sums rounded as OpenCV's fixed-point divide does; float32 and
  float64 with OpenCV's sums in double, in its order (rows of 3 or 5, and
  of any window up to 5x5, summed directly; other rows and the columns as
  running sums), so bit for bit.

Images are ``[h, w]`` or ``[h, w, c]``; a one-channel ``[h, w, 1]`` image
comes back ``[h, w]``, as from ``cv2``. Float32 fused multiply-adds are
computed exactly in float64 and rounded once.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BLOCK_ROWS = 64  # output rows a thread interpolates at a time
_VECTOR_COLUMNS = 16  # columns a step of OpenCV's vector warp loop covers
_TAB = 32  # OpenCV's INTER_TAB_SIZE: sub-pixel steps of the fixed-point path
_SUPPORTED = (np.dtype(np.uint8), np.dtype(np.float32), np.dtype(np.float64))


def _f32(values) -> np.ndarray:
    """Values rounded to float32, held in float64 for exact products."""
    return np.asarray(values, np.float32).astype(np.float64)


def _as_hwc(image: np.ndarray, what: str) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype not in _SUPPORTED:
        msg = f"{what} takes uint8, float32 or float64 images, got {image.dtype}."
        raise ValueError(msg)
    if image.ndim not in (2, 3) or 0 in image.shape:
        msg = f"{what} takes a non-empty [h, w] or [h, w, c] image, got shape {image.shape}."
        raise ValueError(msg)
    return image.reshape(image.shape[0], image.shape[1], -1)


def _shaped(out: np.ndarray) -> np.ndarray:
    """``[h, w, 1]`` -> ``[h, w]``, as ``cv2`` returns one channel."""
    return out[..., 0] if out.shape[-1] == 1 else out


def _border(border_value, channels: int, dtype: np.dtype) -> np.ndarray:
    """The border value per channel, saturated to the image's type."""
    values = np.broadcast_to(np.asarray(border_value, np.float64).ravel(), (channels,))
    if dtype == np.uint8:
        values = np.clip(np.rint(values), 0, 255)
    elif dtype == np.float32:
        values = _f32(values)
    return values.astype(np.float64)


def _padded(src: np.ndarray, border: np.ndarray) -> np.ndarray:
    """The image in a one-pixel frame of the border value: every tap of a
    position that is not wholly outside then lies in the frame. Float32
    holds uint8 and float32 pixels exactly."""
    h, w, c = src.shape
    dtype = np.float64 if src.dtype == np.float64 else np.float32
    out = np.empty((h + 2, w + 2, c), dtype)
    out[...] = border.astype(dtype)
    out[1:-1, 1:-1] = src
    return out


def _taps(padded: np.ndarray, ix: np.ndarray, iy: np.ndarray) -> tuple[np.ndarray, ...]:
    """The four neighbours of each position from the framed image."""
    hp, wp, c = padded.shape
    base = (np.clip(iy, -1, hp - 3) + 1) * wp + np.clip(ix, -1, wp - 3) + 1
    flat = padded.reshape(-1, c)
    return flat[base], flat[base + 1], flat[base + wp], flat[base + wp + 1]


def _outside(ix: np.ndarray, iy: np.ndarray, padded: np.ndarray) -> np.ndarray:
    """Positions whose four taps are all outside the image."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    return (ix >= w) | (ix < -1) | (iy >= h) | (iy < -1)


def _bilinear_f32(padded: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: np.ndarray, dtype) -> np.ndarray:
    """OpenCV's float32 bilinear at float32 positions (uint8 and float32 images)."""
    fx, fy = np.floor(sx), np.floor(sy)
    ax = _f32(sx - fx)[..., None]
    ay = _f32(sy - fy)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    p00, p01, p10, p11 = _taps(padded, ix, iy)
    top = _f32(ax * (p01 - p00) + p00)
    bottom = _f32(ax * (p11 - p10) + p10)
    out = _f32(ay * _f32(bottom - top) + top)
    if dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255)
    out[_outside(ix, iy, padded)] = border
    return out.astype(dtype)


def _bilinear_fixed(padded: np.ndarray, x32: np.ndarray, y32: np.ndarray, border: np.ndarray) -> np.ndarray:
    """OpenCV's fixed-point bilinear (float64 images): positions in 1/32 of a
    pixel, weights from its float32 table, the four products summed in
    double in tap order."""
    ix = np.clip(x32 >> 5, -32768, 32767)
    iy = np.clip(y32 >> 5, -32768, 32767)
    steps = np.arange(_TAB, dtype=np.float32) * np.float32(1.0 / _TAB)
    lo, hi = np.float32(1) - steps, steps
    fx, fy = x32 & (_TAB - 1), y32 & (_TAB - 1)
    weights = [(lo[fy] * lo[fx]), (lo[fy] * hi[fx]), (hi[fy] * lo[fx]), (hi[fy] * hi[fx])]
    taps = _taps(padded, ix, iy)
    out = taps[0] * weights[0].astype(np.float64)[..., None]
    for tap, weight in zip(taps[1:], weights[1:]):
        out = out + tap * weight.astype(np.float64)[..., None]
    out[_outside(ix, iy, padded)] = border
    return out


def _by_row_blocks(out_h: int, out_w: int, channels: int, dtype, rows_fn) -> np.ndarray:
    """``rows_fn(y0, y1)`` over blocks of output rows, on a thread each
    (numpy releases the interpreter lock inside its array loops)."""
    out = np.empty((out_h, out_w, channels), dtype)
    starts = range(0, out_h, _BLOCK_ROWS)

    def block(y0: int) -> None:
        out[y0 : y0 + _BLOCK_ROWS] = rows_fn(y0, min(y0 + _BLOCK_ROWS, out_h))

    with ThreadPoolExecutor(max_workers=max(1, min(len(starts), os.cpu_count() or 1))) as pool:
        for future in [pool.submit(block, y0) for y0 in starts]:
            future.result()
    return out


def _inverse_affine(matrix) -> np.ndarray:
    """OpenCV's inversion of a 2x3 affine, in double (``warpAffine`` without
    ``WARP_INVERSE_MAP``)."""
    m = np.asarray(matrix, np.float64).reshape(-1)[:6].copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[4] = a11, a22
    m[1] *= -det
    m[3] *= -det
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(image: np.ndarray, matrix, dsize: tuple[int, int], border_value=0) -> np.ndarray:
    """``cv2.warpAffine(image, matrix, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)``.

    Args:
        image: uint8, float32 or float64 ``[h, w]`` or ``[h, w, c]``.
        matrix: 2x3 (or 3x3) affine mapping the image onto the output.
        dsize: Output (width, height).
        border_value: Scalar or one value per channel.
    """
    src = _as_hwc(image, "warp_affine")
    out_w, out_h = int(dsize[0]), int(dsize[1])
    m = _inverse_affine(matrix)
    border = _border(border_value, src.shape[2], src.dtype)
    padded = _padded(src, border)
    x = np.arange(out_w, dtype=np.float64)[None, :]
    if src.dtype == np.float64:
        # AB_BITS = 10: rows and column steps in 1/1024, rounded half to even
        col_x = np.rint(m[0] * x * 1024).astype(np.int64)
        col_y = np.rint(m[3] * x * 1024).astype(np.int64)

        def fixed_rows(y0: int, y1: int) -> np.ndarray:
            y = np.arange(y0, y1, dtype=np.float64)[:, None]
            row_x = np.rint((m[1] * y + m[2]) * 1024).astype(np.int64) + 16
            row_y = np.rint((m[4] * y + m[5]) * 1024).astype(np.int64) + 16
            return _bilinear_fixed(padded, (row_x + col_x) >> 5, (row_y + col_y) >> 5, border)

        return _shaped(_by_row_blocks(out_h, out_w, src.shape[2], src.dtype, fixed_rows))
    m = _f32(m)
    tail = x[:, out_w - out_w % _VECTOR_COLUMNS :]

    def rows(y0: int, y1: int) -> np.ndarray:
        y = np.arange(y0, y1, dtype=np.float64)[:, None]
        sx = _f32(x * m[0] + _f32(_f32(y * m[1]) + m[2]))
        sy = _f32(x * m[3] + _f32(_f32(y * m[4]) + m[5]))
        if tail.size:
            sx[:, -tail.size :] = _f32(_f32(tail * m[0] + _f32(y * m[1])) + m[2])
            sy[:, -tail.size :] = _f32(_f32(tail * m[3] + _f32(y * m[4])) + m[5])
        return _bilinear_f32(padded, sx, sy, border, src.dtype)

    return _shaped(_by_row_blocks(out_h, out_w, src.shape[2], src.dtype, rows))


def remap_linear(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray, border_value=0) -> np.ndarray:
    """``cv2.remap(image, map_x, map_y, INTER_LINEAR, borderMode=BORDER_CONSTANT,
    borderValue=border_value)`` with float32 maps of the output's shape."""
    src = _as_hwc(image, "remap_linear")
    map_x = np.asarray(map_x, np.float32)
    map_y = np.asarray(map_y, np.float32)
    if map_x.shape != map_y.shape or map_x.ndim != 2:
        msg = f"remap_linear takes two [h, w] maps of one shape, got {map_x.shape} and {map_y.shape}."
        raise ValueError(msg)
    border = _border(border_value, src.shape[2], src.dtype)
    padded = _padded(src, border)

    def rows(y0: int, y1: int) -> np.ndarray:
        mx = map_x[y0:y1].astype(np.float64)
        my = map_y[y0:y1].astype(np.float64)
        if src.dtype == np.float64:
            x32 = np.rint(mx * _TAB).astype(np.int64)
            y32 = np.rint(my * _TAB).astype(np.int64)
            return _bilinear_fixed(padded, x32, y32, border)
        return _bilinear_f32(padded, mx, my, border, src.dtype)

    return _shaped(_by_row_blocks(*map_x.shape, src.shape[2], src.dtype, rows))


def _positions(n_in: int, n_out: int) -> np.ndarray:
    """Source position of each output sample: half-pixel centres."""
    return (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5


def _resize_u8(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = src.shape[:2]
    # horizontal taps: float32 positions, clamped to the image at both ends
    fx = np.float32(_positions(w, out_w))
    x0 = np.floor(fx).astype(np.int64)
    fx = (fx - np.float32(x0)).astype(np.float32)
    edge = (x0 < 0) | (x0 >= w - 1)
    fx[edge] = 0
    x0 = np.clip(x0, 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    ax0 = np.rint((np.float32(1) - fx).astype(np.float64) * 2048).astype(np.int64)[None, :, None]
    ax1 = np.rint(fx.astype(np.float64) * 2048).astype(np.int64)[None, :, None]
    # vertical taps: the weights are not clamped; the rows are
    fy = np.float32(_positions(h, out_h))
    y0 = np.floor(fy).astype(np.int64)
    fy = (fy - np.float32(y0)).astype(np.float32)
    by0 = np.rint((np.float32(1) - fy).astype(np.float64) * 2048).astype(np.int64)[:, None, None]
    by1 = np.rint(fy.astype(np.float64) * 2048).astype(np.int64)[:, None, None]
    pix = src.astype(np.int64)
    rows = np.where(edge[None, :, None], pix[:, x0] * 2048, pix[:, x0] * ax0 + pix[:, x1] * ax1)
    top = rows[np.clip(y0, 0, h - 1)] >> 4
    bottom = rows[np.clip(y0 + 1, 0, h - 1)] >> 4
    out = (((by0 * top) >> 16) + ((by1 * bottom) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_float(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = src.shape[:2]
    fx = _positions(w, out_w)
    x0 = np.floor(fx).astype(np.int64)
    fx = fx - x0
    fx[(x0 < 0) | (x0 >= w - 1)] = 0
    x0 = np.clip(x0, 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = _positions(h, out_h)
    y0 = np.floor(fy).astype(np.int64)
    fy = (fy - y0)[:, None, None]
    pix = src.astype(np.float64)
    rows = pix[:, x0] + fx[None, :, None] * (pix[:, x1] - pix[:, x0])
    top = rows[np.clip(y0, 0, h - 1)]
    out = top + fy * (rows[np.clip(y0 + 1, 0, h - 1)] - top)
    return out.astype(src.dtype)


def resize_linear(image: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, dsize, interpolation=INTER_LINEAR)``; ``dsize`` is
    (width, height)."""
    src = _as_hwc(image, "resize_linear")
    out_w, out_h = int(dsize[0]), int(dsize[1])
    if out_w < 1 or out_h < 1:
        msg = f"resize_linear needs a positive output size, got {dsize}."
        raise ValueError(msg)
    if (out_w, out_h) == src.shape[1::-1]:
        return _shaped(src.copy())
    resize = _resize_u8 if src.dtype == np.uint8 else _resize_float
    return _shaped(resize(src, out_w, out_h))


def _reflect_101(n: int, before: int, after: int) -> np.ndarray:
    """Indices of ``BORDER_REFLECT_101`` padding (``gfedcb|abcdefgh|gfedcba``)."""
    idx = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def box_blur(image: np.ndarray, ksize) -> np.ndarray:
    """``cv2.blur(image, ksize)``: the mean over a ``ksize`` (width, height)
    window centred at ``ksize // 2``, borders reflected (101)."""
    src = _as_hwc(image, "box_blur")
    kw, kh = (int(ksize), int(ksize)) if np.ndim(ksize) == 0 else (int(ksize[0]), int(ksize[1]))
    if kw < 1 or kh < 1:
        msg = f"box_blur needs a positive kernel size, got {ksize}."
        raise ValueError(msg)
    h, w = src.shape[:2]
    ax, ay = kw // 2, kh // 2
    padded = src[_reflect_101(h, ay, kh - 1 - ay)][:, _reflect_101(w, ax, kw - 1 - ax)]
    area = kw * kh
    if src.dtype == np.uint8:
        sums = np.cumsum(np.pad(padded.astype(np.int64), ((1, 0), (1, 0), (0, 0))), 0).cumsum(1)
        total = sums[kh:, kw:] - sums[:-kh, kw:] - sums[kh:, :-kw] + sums[:-kh, :-kw]
        if area <= 256:
            # OpenCV's 16-bit column sums divide in 23-bit fixed point
            scale = float(1 << 23) / area
            div_scale, div_delta = int(np.floor(scale)), area // 2
            if scale - div_scale < 0.5:
                div_delta += 1
            else:
                div_scale += 1
            out = ((total + div_delta) * div_scale) >> 23
        else:
            out = np.rint(total * (1.0 / area))
        return _shaped(np.clip(out, 0, 255).astype(np.uint8))
    # rows: 3 and 5 wide windows (and any up to 5x5) summed left to right,
    # others as a running sum, s += S[i + k] - S[i]
    pix = padded.astype(np.float64)
    if kw in (3, 5) or (kw <= 5 and kh <= 5):
        rows = pix[:, :w]
        for j in range(1, kw):
            rows = rows + pix[:, j : j + w]
    else:
        first = pix[:, 0]
        for j in range(1, kw):
            first = first + pix[:, j]
        rows = np.add.accumulate(np.concatenate([first[:, None], pix[:, kw:] - pix[:, :-kw]], axis=1), axis=1)
    # columns: a running sum down the rows, scaled as each row is written
    running = np.zeros_like(rows[0])
    for i in range(kh - 1):
        running = running + rows[i]
    out = np.empty((h, w, src.shape[2]), np.float64)
    scale = 1.0 / area
    for y in range(h):
        total = running + rows[y + kh - 1]
        out[y] = total * scale
        running = total - rows[y]
    return _shaped(out.astype(src.dtype))
