"""Shared architecture utilities (counterpart of ``tiatoolbox_tpu/models/architecture/utils.py:1-114``).

``argmax_last_axis``, ``centre_crop``, ``centre_crop_to_shape``,
``upsample2x`` (nearest) and ``resize_bilinear`` on numpy arrays or torch
tensors. ``data_format`` names the axis order of a 4-D batch: "NHWC" (the
JAX default) or "NCHW" (PyTorch's, which a channels_last tensor keeps in
its shape). The detectors' peak tools (:61-114),
``peak_detection_map_overlap`` and ``nms_on_detection_maps``, run on the
host with the same numpy and scipy calls in the same order, so their
results, the order of tied peaks included, are JAX's.

``is_torch_compile_compatible`` and ``compile_model`` (:115-137) are shims
in JAX; here they wrap ``torch.compile`` as upstream tiatoolbox does, with
JAX's check of ``mode``. Nothing on the port's paths calls them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from scipy.spatial import cKDTree

_FORMATS = ("NCHW", "NHWC")


def _check_format(data_format: str) -> None:
    if data_format not in _FORMATS:
        msg = f"Unknown input format `{data_format}`."
        raise ValueError(msg)


def argmax_last_axis(image):
    """argmax over the last axis (numpy arrays or torch tensors)."""
    if isinstance(image, np.ndarray):
        return np.argmax(image, axis=-1)
    return torch.argmax(image, dim=-1)


def centre_crop(img, crop_shape, data_format: str = "NHWC"):
    """Remove ``crop_shape`` = [dh, dw] pixels, centred (``utils.py:20``)."""
    _check_format(data_format)
    crop_t = int(crop_shape[0] // 2)
    crop_b = int(crop_shape[0] - crop_t)
    crop_l = int(crop_shape[1] // 2)
    crop_r = int(crop_shape[1] - crop_l)
    if data_format == "NCHW":
        return img[:, :, crop_t : img.shape[2] - crop_b, crop_l : img.shape[3] - crop_r]
    return img[:, crop_t : img.shape[1] - crop_b, crop_l : img.shape[2] - crop_r, :]


def centre_crop_to_shape(x, y, data_format: str = "NHWC"):
    """Centre crop ``x`` to the spatial shape of ``y`` (``utils.py:35``)."""
    _check_format(data_format)
    if data_format == "NCHW":
        crop_shape = (x.shape[2] - y.shape[2], x.shape[3] - y.shape[3])
    else:
        crop_shape = (x.shape[1] - y.shape[1], x.shape[2] - y.shape[2])
    if crop_shape[0] < 0 or crop_shape[1] < 0:
        msg = "Height or width of `x` is smaller than `y`."
        raise ValueError(msg)
    if crop_shape == (0, 0):
        return x
    return centre_crop(x, crop_shape, data_format)


def _as_nchw(x: torch.Tensor, data_format: str) -> torch.Tensor:
    _check_format(data_format)
    return x if data_format == "NCHW" else x.permute(0, 3, 1, 2)


def _from_nchw(x: torch.Tensor, data_format: str) -> torch.Tensor:
    return x if data_format == "NCHW" else x.permute(0, 2, 3, 1)


def upsample2x(x: torch.Tensor, data_format: str = "NHWC") -> torch.Tensor:
    """Nearest-neighbour 2x upsample (``utils.py:50``, reference UpSample2x)."""
    out = F.interpolate(_as_nchw(x, data_format), scale_factor=2, mode="nearest")
    return _from_nchw(out, data_format)


def resize_bilinear(x: torch.Tensor, scale: int = 2, data_format: str = "NHWC") -> torch.Tensor:
    """Bilinear resize by an integer scale, half-pixel centres (``utils.py:58``).

    ``jax.image.resize(..., "bilinear")`` drops the weights of taps outside
    the image and renormalises; PyTorch clamps the source coordinate. At an
    integer upscale both weight the edge pixel alone on the border rows and
    columns, and agree there within 1e-6 (``tests/test_torch_unet.py``
    checks them on their own).
    """
    out = F.interpolate(
        _as_nchw(x, data_format), scale_factor=scale, mode="bilinear", align_corners=False
    )
    return _from_nchw(out, data_format)


def peak_detection_map_overlap(
    detection_map: np.ndarray,
    min_distance: int = 6,
    threshold_abs: float = 0.5,
) -> np.ndarray:
    """[N, 2] (row, col) of the local maxima above ``threshold_abs`` (``utils.py:61``).

    A peak is the largest value of its ``(2 * min_distance + 1)`` square
    window (zero outside the map) and exceeds ``threshold_abs``; peaks come
    in descending intensity, in ``np.argsort``'s order on ties.
    """
    size = 2 * min_distance + 1
    local_max = ndimage.maximum_filter(detection_map, size=size, mode="constant")
    mask = (detection_map == local_max) & (detection_map > threshold_abs)
    coords = np.argwhere(mask)
    if len(coords):
        intensities = detection_map[coords[:, 0], coords[:, 1]]
        coords = coords[np.argsort(-intensities)]
    return coords


def nms_on_detection_maps(coords: np.ndarray, scores: np.ndarray, radius: float) -> np.ndarray:
    """Indices of the detections kept by greedy non-maximum suppression (``utils.py:86``).

    In descending score, a detection is kept unless a kept one lies within
    ``radius`` of it (``cKDTree.query_ball_point``).
    """
    if len(coords) == 0:
        return np.array([], dtype=int)
    coords = np.asarray(coords, dtype=float)
    order = np.argsort(-np.asarray(scores))
    tree = cKDTree(coords)
    suppressed = np.zeros(len(coords), dtype=bool)
    kept: list[int] = []
    for idx in order:
        if suppressed[idx]:
            continue
        kept.append(int(idx))
        for j in tree.query_ball_point(coords[idx], r=radius):
            if j != idx:
                suppressed[j] = True
    return np.array(kept, dtype=int)


def peak_map(block: np.ndarray, min_distance: int, threshold_abs: float) -> np.ndarray:
    """1.0 at each channel's peaks of an HWC map, else 0 (the detectors'
    ``postproc``, ``mapde.py:113`` and ``sccnn.py:118``)."""
    block = np.asarray(block)
    out = np.zeros_like(block, dtype=np.float32)
    for c in range(block.shape[-1]):
        coords = peak_detection_map_overlap(block[..., c], min_distance=min_distance, threshold_abs=threshold_abs)
        if len(coords):
            out[coords[:, 0], coords[:, 1], c] = 1.0
    return out


_COMPILE_MODES = ("default", "reduce-overhead", "max-autotune", "disable")


def is_torch_compile_compatible() -> bool:
    """Whether ``torch.compile`` may be used: a CUDA card of compute capability 7.0, 8.0 or 9.0.

    Upstream's gate; the CPU is not compatible (JAX's shim answers True).
    """
    from tiatoolbox_tpu_torch import logger

    if not torch.cuda.is_available():
        logger.warning("No GPU detected: torch.compile is not used.")
        return False
    capability = torch.cuda.get_device_capability()
    if capability not in ((7, 0), (8, 0), (9, 0)):
        logger.warning("GPU of compute capability %s is not compatible with torch.compile.", capability)
        return False
    return True


def compile_model(model=None, *, mode: str = "default"):
    """``torch.compile(model, mode=mode)``, or ``model`` itself where compiling does not apply.

    ``mode`` is one of "default", "reduce-overhead", "max-autotune" and
    "disable" (JAX's check); "disable", an incompatible device and a model
    compiled already return ``model`` unchanged.
    """
    if mode not in _COMPILE_MODES:
        msg = f"Invalid mode: {mode}."
        raise ValueError(msg)
    if model is None or mode == "disable" or not is_torch_compile_compatible():
        return model
    if isinstance(model, torch._dynamo.eval_frame.OptimizedModule):  # noqa: SLF001
        return model
    return torch.compile(model, mode=mode)
