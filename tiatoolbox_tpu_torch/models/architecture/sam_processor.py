"""SAM's pre- and post-processing: ``SamProcessor`` without PIL or transformers.

Counterpart of ``transformers.models.sam.image_processing_sam`` and
``processing_sam`` (4.57), which JAX's ``SAM`` calls
(``tiatoolbox_tpu/models/architecture/sam.py:63-77``):

- ``preprocess_shape`` (``_get_preprocess_shape`` :203): the longest edge
  over ``max(h, w)`` as the scale, each side ``int(x * scale + 0.5)``;
- ``resize_bilinear_u8``: transformers resizes a uint8 image through
  ``PIL.Image.resize(BILINEAR)`` (``image_transforms.py`` ``resize``), and
  this is Pillow's ``Resample.c`` bit for bit: the triangle filter's
  support widened by the scale where a side shrinks, each output's taps
  from ``(int)(centre -+ support + 0.5)`` clipped to the image, weights
  normalised in float64 and rounded to 22-bit fixed point, the horizontal
  pass first, each pass rounding (the half added before the shift) and
  clipping to uint8. The taps are computed on the host in float64, as
  Pillow does; the passes are integer sums on the image's device, so the
  card gives the CPU's bytes;
- ``preprocess``: the resample, then ``x * rescale_factor`` in float64 cast
  to float32 (``image_transforms.rescale``), ``(x - mean) / std`` in
  float32 (``normalize``), zeros padded to the bottom and right (``pad_image``
  :166), channels first;
- ``scale_points`` and ``scale_boxes`` (``_normalize_coordinates``
  ``processing_sam.py:220``): coordinates times new/old size per axis, in
  float64 (boxes first pass through float32, :282);
- ``post_process_masks`` (:577): bilinear upsampling (``align_corners=False``)
  to the pad size, a crop to the resized size, bilinear resizing to the
  original size, ``> 0``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tiatoolbox_tpu_torch.models.architecture.sam_config import PreprocessorConfig

_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit coefficients (Resample.c)


def preprocess_shape(old_hw: tuple[int, int], longest_edge: int) -> tuple[int, int]:
    """(h, w) scaled so the longest side is ``longest_edge``, rounded half up."""
    h, w = old_hw
    scale = longest_edge * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's bilinear taps for one axis (``precompute_coeffs`` then
    ``normalize_coeffs_8bpc``): the first input index and the tap count of
    each output, and the int32 weights [out_size, ksize] (zero past the count)."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centre = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((centre - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centre + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.maximum(1.0 - np.abs((taps[None, :] + xmin[:, None] - centre[:, None] + 0.5) * ss), 0.0)
    w = np.where(live, w, 0.0)
    total = np.zeros(out_size)
    for x in range(ksize):  # Pillow's order of summation
        total = total + w[:, x]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)), np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, xmax, fixed.astype(np.int32)


def _resample_axis(image: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """One pass of Pillow's 8-bit resample along ``axis`` of an int32 image."""
    xmin, xmax, weights = bilinear_taps(image.shape[axis], out_size)
    last = image.shape[axis] - 1
    acc = torch.full(
        [*image.shape[:axis], out_size, *image.shape[axis + 1 :]], 1 << (_PRECISION_BITS - 1),
        dtype=torch.int32, device=image.device,
    )
    view = [1] * image.dim()
    view[axis] = out_size
    for x in range(weights.shape[1]):
        if not (xmax > x).any():
            break
        index = torch.from_numpy(np.minimum(xmin + x, last)).to(image.device)
        weight = torch.from_numpy(weights[:, x]).to(image.device).reshape(view)
        acc += image.index_select(axis, index) * weight
    return (acc >> _PRECISION_BITS).clamp_(0, 255)


def resize_bilinear_u8(image: torch.Tensor, size_hw: tuple[int, int]) -> torch.Tensor:
    """``PIL.Image.fromarray(image).resize((w, h), BILINEAR)`` for a uint8 [H, W, C] tensor."""
    if image.dtype != torch.uint8 or image.dim() != 3:
        msg = f"resize_bilinear_u8 takes a uint8 [H, W, C] image, not {image.dtype} {tuple(image.shape)}."
        raise ValueError(msg)
    out_h, out_w = size_hw
    x = image.to(torch.int32)
    if out_w != image.shape[1]:
        x = _resample_axis(x, out_w, axis=1)
    if out_h != image.shape[0]:
        x = _resample_axis(x, out_h, axis=0)
    return x.to(torch.uint8)


def preprocess(
    image: np.ndarray | torch.Tensor, config: PreprocessorConfig, device: torch.device | str
) -> tuple[torch.Tensor, tuple[int, int], tuple[int, int]]:
    """uint8 [H, W, 3] -> float32 [3, pad_h, pad_w] pixel values, the original
    (h, w) and the resized (h, w), as ``SamImageProcessor.preprocess``."""
    pixels = torch.as_tensor(np.ascontiguousarray(image) if isinstance(image, np.ndarray) else image)
    if pixels.dtype != torch.uint8 or pixels.dim() != 3 or pixels.shape[2] != 3:
        msg = f"SAM takes uint8 [H, W, 3] images, not {pixels.dtype} {tuple(pixels.shape)}."
        raise ValueError(msg)
    original = (int(pixels.shape[0]), int(pixels.shape[1]))
    resized = preprocess_shape(original, config.longest_edge)
    if resized[0] > config.pad_height or resized[1] > config.pad_width:
        msg = f"a {resized} resized image does not fit the {config.pad_height}x{config.pad_width} pad size."
        raise ValueError(msg)
    pixels = resize_bilinear_u8(pixels.to(device), resized)
    x = (pixels.to(torch.float64) * config.rescale_factor).to(torch.float32)
    mean = torch.tensor(config.image_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(config.image_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    x = F.pad(x, (0, 0, 0, config.pad_width - resized[1], 0, config.pad_height - resized[0]))
    return x.permute(2, 0, 1).contiguous(), original, resized


def _coordinate_scale(original: tuple[int, int], longest_edge: int) -> tuple[float, float]:
    new_h, new_w = preprocess_shape(original, longest_edge)
    return new_w / original[1], new_h / original[0]


def scale_points(points, original: tuple[int, int], longest_edge: int) -> np.ndarray:
    """[x, y] points of the original image -> float64 [N, 2] in the resized image."""
    coords = np.array(points, dtype=np.float64).reshape(-1, 2)
    sx, sy = _coordinate_scale(original, longest_edge)
    coords[:, 0] = coords[:, 0] * sx
    coords[:, 1] = coords[:, 1] * sy
    return coords


def scale_boxes(boxes, original: tuple[int, int], longest_edge: int) -> np.ndarray:
    """[x0, y0, x1, y1] boxes (a box, or nested lists or an array of boxes)
    -> float64 [N, 4] in the resized image."""
    coords = np.array(boxes, dtype=np.float32).astype(np.float64).reshape(-1, 2, 2)
    sx, sy = _coordinate_scale(original, longest_edge)
    coords[..., 0] = coords[..., 0] * sx
    coords[..., 1] = coords[..., 1] * sy
    return coords.reshape(-1, 4)


def upscale_logits(
    masks: torch.Tensor, original: tuple[int, int], resized: tuple[int, int], config: PreprocessorConfig
) -> torch.Tensor:
    """Low-resolution logits [P, M, h, w] -> logits [P, M, H, W] of the original image."""
    up = F.interpolate(masks, (config.pad_height, config.pad_width), mode="bilinear", align_corners=False)
    up = up[..., : resized[0], : resized[1]]
    return F.interpolate(up, original, mode="bilinear", align_corners=False)


def post_process_masks(
    masks: torch.Tensor, original: tuple[int, int], resized: tuple[int, int], config: PreprocessorConfig
) -> torch.Tensor:
    """Low-resolution logits [P, M, h, w] -> bool masks [P, M, H, W] (``> 0``)."""
    return upscale_logits(masks, original, resized, config) > 0.0
