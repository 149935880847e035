"""Stain-normalisation tile transform: the CUDA kernel and its plain version.

Counterpart of ``tiatoolbox_tpu/ops/stain.py``. ``stain_transform`` applies
precomputed stain matrices to a uint8 RGB batch:

    uint8 RGB -> OD -> concentrations (od @ P) -> scale -> exp -> uint8 RGB

On a CUDA tensor it launches the hand-written kernel in ``csrc/stain.cu``
(which replaces the Pallas ``_stain_kernel``, ``stain.py:58-135``); on a CPU
tensor it runs ``stain_transform_reference``, the plain PyTorch version of
``stain.py:35-56``. A CUDA tensor never falls back to the plain version: the
kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tiatoolbox_tpu_torch import _build

SOURCE = "stain.cu"


class StainCoefs(ctypes.Structure):
    """The kernel's by-value coefficient struct (``csrc/stain.cu``)."""

    _fields_ = [
        ("p", ctypes.c_float * 6),
        ("s", ctypes.c_float * 2),
        ("m", ctypes.c_float * 6),
    ]


def _as_f32(values, shape: tuple[int, ...]) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    arr = np.asarray(values, np.float32)
    if arr.size != int(np.prod(shape)):
        msg = f"Expected {int(np.prod(shape))} coefficients, got shape {arr.shape}."
        raise ValueError(msg)
    return arr.reshape(shape)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its argument types set once per process."""
    lib = _build.load(SOURCE)
    fn = lib.stain_transform_u8
    fn.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        StainCoefs,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.stain_error_string.argtypes = [ctypes.c_int]
    lib.stain_error_string.restype = ctypes.c_char_p
    return lib


def stain_transform_reference(
    tiles: torch.Tensor, conc_proj, target_stains, conc_scale
) -> torch.Tensor:
    """Plain PyTorch stain transform in float32 (``stain.py:35-56``).

    Args:
        tiles: uint8 tensor ``[..., 3]``.
        conc_proj: float32 ``[3, 2]`` projection OD -> concentrations.
        target_stains: float32 ``[2, 3]`` target stain matrix.
        conc_scale: float32 ``[2]`` per-stain concentration rescale.

    Returns:
        uint8 tensor of the same shape, on the same device.
    """
    dev = tiles.device
    proj = torch.from_numpy(_as_f32(conc_proj, (3, 2))).to(dev)
    stains = torch.from_numpy(_as_f32(target_stains, (2, 3))).to(dev)
    scale = torch.from_numpy(_as_f32(conc_scale, (2,))).to(dev)
    x = tiles.to(torch.float32).clamp_min_(1.0)
    od = torch.clamp_min(-torch.log(x / 255.0), 1e-6)
    conc = (od @ proj) * scale
    out = 255.0 * torch.exp(-(conc @ stains))
    return out.clamp_(0.0, 255.0).to(torch.uint8)


def stain_transform(
    tiles: torch.Tensor, conc_proj, target_stains, conc_scale
) -> torch.Tensor:
    """Apply a precomputed stain transform to uint8 RGB tiles.

    A CPU tensor goes to ``stain_transform_reference``. A CUDA tensor must be
    contiguous; the kernel runs on the current stream and the result is
    a new tensor. ``stain_transform.launches`` counts kernel launches.

    Args:
        tiles: uint8 tensor ``[..., 3]``.
        conc_proj: float32 ``[3, 2]``.
        target_stains: float32 ``[2, 3]``.
        conc_scale: float32 ``[2]``.

    Raises:
        TypeError / ValueError: wrong type, dtype, last dim or layout.
        RuntimeError: the kernel failed to build or to launch.
    """
    if not isinstance(tiles, torch.Tensor):
        msg = f"tiles must be a torch.Tensor, got {type(tiles).__name__}."
        raise TypeError(msg)
    if tiles.dtype != torch.uint8:
        msg = f"tiles must be uint8, got {tiles.dtype}."
        raise ValueError(msg)
    if tiles.ndim == 0 or tiles.shape[-1] != 3:
        msg = f"tiles must have a last dimension of 3, got shape {tuple(tiles.shape)}."
        raise ValueError(msg)
    if tiles.device.type == "cpu":
        return stain_transform_reference(tiles, conc_proj, target_stains, conc_scale)
    if tiles.device.type != "cuda":
        msg = f"stain_transform runs on cpu or cuda tensors, got {tiles.device}."
        raise ValueError(msg)
    if not tiles.is_contiguous():
        msg = "tiles must be contiguous."
        raise ValueError(msg)
    coefs = StainCoefs(
        (ctypes.c_float * 6)(*_as_f32(conc_proj, (6,))),
        (ctypes.c_float * 2)(*_as_f32(conc_scale, (2,))),
        (ctypes.c_float * 6)(*_as_f32(target_stains, (6,))),
    )
    out = torch.empty_like(tiles)
    n_pix = tiles.numel() // 3
    if n_pix == 0:
        return out
    lib = _library()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        code = lib.stain_transform_u8(
            tiles.data_ptr(), out.data_ptr(), n_pix, coefs, stream
        )
    if code != 0:
        msg = f"stain_transform_u8 failed: {lib.stain_error_string(code).decode()}"
        raise RuntimeError(msg)
    stain_transform.launches += 1
    return out


stain_transform.launches = 0
