"""OpenCV's bilinear geometry and box filter on the host.

JAX's registration (``tiatoolbox_tpu/tools/registration/wsi_registration.py``)
and ``TransformedWSIReader`` (``wsicore/store_reader.py``) warp, resample
and smooth through ``cv2``, which the card machine does not have.
``prealignment`` picks the best of 36 rotations by the Dice score of a
warped mask, so those warps must be OpenCV's bit for bit, or the chosen
angle can differ. Each function here is a call into the port's host C++
(``csrc/imgproc.cpp`` through ``tiatoolbox_tpu_torch.native``), which
reproduces OpenCV 5.0 as it runs on x86-64 (its AVX-512 dispatch):

- ``warp_affine`` (``cv2.warpAffine``, ``INTER_LINEAR``, ``BORDER_CONSTANT``):
  uint8 and float32 images in OpenCV's float32 kernel (the matrix inverted
  in double and rounded to float32, fused multiply-adds, the 16-column
  vector/tail split of the source positions), float64 images in its
  fixed-point path (positions in 1/32 of a pixel, weights from its float32
  table, summed in double);
- ``remap_linear`` (``cv2.remap`` with float32 maps): the same
  interpolation at the map's positions (float64 images: positions rounded
  to 1/32);
- ``resize_linear`` (``cv2.resize``, ``INTER_LINEAR``): uint8 in OpenCV's
  11-bit fixed point; float32 as Intel IPP's linear resize, which cv2 runs
  there (a fused lerp, rows first); float64 within 1e-14 of it;
- ``box_blur`` (``cv2.blur``, ``BORDER_REFLECT_101``): OpenCV's row and
  column sums and its rounding of the mean.

Images are uint8, float32 or float64 ``[h, w]`` or ``[h, w, c]``; a
one-channel ``[h, w, 1]`` image comes back ``[h, w]``, as from ``cv2``.
"""

from __future__ import annotations

import numpy as np

from tiatoolbox_tpu_torch import native

_SUPPORTED = (np.dtype(np.uint8), np.dtype(np.float32), np.dtype(np.float64))


def warp_affine(image: np.ndarray, matrix, dsize: tuple[int, int], border_value=0) -> np.ndarray:
    """``cv2.warpAffine(image, matrix, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)``.

    Args:
        image: uint8, float32 or float64 ``[h, w]`` or ``[h, w, c]``.
        matrix: 2x3 (or 3x3) affine mapping the image onto the output.
        dsize: Output (width, height).
        border_value: Scalar or one value per channel.
    """
    return native.warp_affine(image, matrix, dsize, border_value)


def remap_linear(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray, border_value=0) -> np.ndarray:
    """``cv2.remap(image, map_x, map_y, INTER_LINEAR, borderMode=BORDER_CONSTANT,
    borderValue=border_value)`` with float32 maps of the output's shape."""
    return native.remap(image, map_x, map_y, border_value)


def resize_linear(image: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, dsize, interpolation=INTER_LINEAR)`` of a uint8,
    float32 or float64 image; ``dsize`` is (width, height)."""
    image = np.asarray(image)
    if image.dtype not in _SUPPORTED:
        msg = f"resize_linear takes uint8, float32 or float64 images, got {image.dtype}."
        raise ValueError(msg)
    return native.resize(image, dsize, "linear")


def box_blur(image: np.ndarray, ksize) -> np.ndarray:
    """``cv2.blur(image, ksize)``: the mean over a ``ksize`` (width, height)
    window centred at ``ksize // 2``, borders reflected (101)."""
    return native.blur(image, ksize)
