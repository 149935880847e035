"""Shared architecture utilities (counterpart of ``tiatoolbox_tpu/models/architecture/utils.py:1-70``).

``argmax_last_axis``, ``centre_crop``, ``centre_crop_to_shape``,
``upsample2x`` (nearest) and ``resize_bilinear`` on numpy arrays or torch
tensors. ``data_format`` names the axis order of a 4-D batch: "NHWC" (the
JAX default) or "NCHW" (PyTorch's, which a channels_last tensor keeps in
its shape). The peak tools (``:72+``) come with the detector engines.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
