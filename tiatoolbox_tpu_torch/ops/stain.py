"""Stain-normalisation tile transform: the CUDA kernel and its plain version.

Counterpart of ``tiatoolbox_tpu/ops/stain.py``. ``stain_transform`` applies
precomputed stain matrices to a uint8 RGB batch:

    uint8 RGB -> OD -> concentrations (od @ P) -> scale -> exp -> uint8 RGB

On a CUDA tensor it launches the hand-written kernel in ``csrc/stain.cu``
(which replaces the Pallas ``_stain_kernel``, ``stain.py:58-135``); on a CPU
tensor it runs ``stain_transform_reference``, the plain PyTorch version of
``stain.py:35-56``. A CUDA tensor never falls back to the plain version: the
kernel launches or the call raises.

``stain_augment`` is the same pipeline with 2 or 3 stains and a factor and
an offset per tile and stain: the second entry of ``csrc/stain.cu``, which
replaces the device program ``augment_tiles_jax``
(``tiatoolbox_tpu/tools/stainaugment.py:129-154``); its plain version is
``stain_augment_reference``. The kernel has two paths, and
``augment_path`` says which one a CUDA batch takes.
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


class AugmentCoefs(ctypes.Structure):
    """The augmentation kernel's by-value coefficient struct (``csrc/stain.cu``)."""

    _fields_ = [("p", ctypes.c_float * 9), ("m", ctypes.c_float * 9)]


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
    aug = lib.stain_augment_u8
    aug.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
        AugmentCoefs,
        ctypes.c_void_p,
    ]
    aug.restype = ctypes.c_int
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


def _check_u8_rgb(tiles, name: str) -> None:
    if not isinstance(tiles, torch.Tensor):
        msg = f"tiles must be a torch.Tensor, got {type(tiles).__name__}."
        raise TypeError(msg)
    if tiles.dtype != torch.uint8:
        msg = f"tiles must be uint8, got {tiles.dtype}."
        raise ValueError(msg)
    if tiles.ndim < 2 or tiles.shape[-1] != 3:
        msg = f"{name}: tiles must be [N, ..., 3], got shape {tuple(tiles.shape)}."
        raise ValueError(msg)


def _augment_factors(values, n: int, s: int, dev: torch.device, name: str) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        t = values.to(torch.float32)
    else:
        t = torch.from_numpy(np.array(values, dtype=np.float32))
    if t.numel() != n * s:
        msg = f"{name} must hold {n} x {s} values (tiles x stains), got shape {tuple(t.shape)}."
        raise ValueError(msg)
    return t.reshape(n, s).to(dev).contiguous()


def stain_augment_reference(tiles: torch.Tensor, conc_proj, stains, alpha, beta) -> torch.Tensor:
    """Plain PyTorch stain augmentation in float32 (``stainaugment.py:151-154``).

    Args:
        tiles: uint8 tensor ``[N, ..., 3]``.
        conc_proj: float32 ``[3, S]`` projection OD -> concentrations.
        stains: float32 ``[S, 3]`` stain matrix.
        alpha: float32 ``[N, S]`` concentration factor of each tile and stain.
        beta: float32 ``[N, S]`` concentration offset of each tile and stain.

    Returns:
        uint8 tensor of the same shape, on the same device.
    """
    _check_u8_rgb(tiles, "stain_augment_reference")
    dev = tiles.device
    m = _as_f32(stains, np.shape(stains))
    s = m.shape[0]
    proj = torch.from_numpy(_as_f32(conc_proj, (3, s))).to(dev)
    n = tiles.shape[0]
    view = (n,) + (1,) * (tiles.ndim - 2) + (s,)
    a = _augment_factors(alpha, n, s, dev, "alpha").reshape(view)
    b = _augment_factors(beta, n, s, dev, "beta").reshape(view)
    x = tiles.to(torch.float32).clamp_min_(1.0)
    od = torch.clamp_min(-torch.log(x / 255.0), 1e-6)
    conc = (od @ proj) * a + b
    out = 255.0 * torch.exp(-(conc @ torch.from_numpy(m).to(dev)))
    return out.clamp_(0.0, 255.0).to(torch.uint8)


def augment_coefs(conc_proj, stains: np.ndarray) -> AugmentCoefs:
    """``stain_augment_u8``'s coefficient struct: P ``[3, S]`` and M ``[S, 3]``, zero-padded to 9."""
    s = stains.shape[0]
    p = np.zeros(9, np.float32)
    p[: 3 * s] = _as_f32(conc_proj, (3 * s,))
    mm = np.zeros(9, np.float32)
    mm[: 3 * s] = stains.reshape(-1)
    return AugmentCoefs((ctypes.c_float * 9)(*p), (ctypes.c_float * 9)(*mm))


def augment_path(tiles: torch.Tensor) -> str:
    """The path of ``csrc/stain.cu``'s ``stain_augment_u8`` that ``tiles`` take.

    ``"tile_uniform"`` where each tile holds a multiple of 16 pixels, the
    tensor starts on a 16-byte boundary (the output is a fresh allocation,
    which does) and the batch has fewer than 2^35 pixels: each 16-pixel chunk
    then lies in one tile, and the kernel's body has no per-pixel tile test.
    ``"general"`` otherwise. Both write the same bytes.
    """
    _check_u8_rgb(tiles, "augment_path")
    n_pix = tiles.numel() // 3
    tile_pix = n_pix // tiles.shape[0] if tiles.shape[0] else 0
    uniform = tile_pix % 16 == 0 and tiles.data_ptr() % 16 == 0 and n_pix // 16 < 1 << 31
    return "tile_uniform" if uniform else "general"


def stain_augment(tiles: torch.Tensor, conc_proj, stains, alpha, beta) -> torch.Tensor:
    """Rescale and shift each tile's stain concentrations and rebuild its RGB.

    A CPU tensor goes to ``stain_augment_reference``. A CUDA tensor must be
    contiguous; the kernel runs on the current stream, on the path that
    ``augment_path`` names, and the result is a new tensor.
    ``stain_augment.launches`` counts kernel launches.

    Args:
        tiles: uint8 tensor ``[N, ..., 3]``; the pixels of ``tiles[i]`` take
            ``alpha[i]`` and ``beta[i]``.
        conc_proj: float32 ``[3, S]``, S = 2 or 3.
        stains: float32 ``[S, 3]``.
        alpha: float32 ``[N, S]`` (an array, or a tensor on any device).
        beta: float32 ``[N, S]``.

    Raises:
        TypeError / ValueError: wrong type, dtype, shape, stain count or layout.
        RuntimeError: the kernel failed to build or to launch.
    """
    _check_u8_rgb(tiles, "stain_augment")
    m = _as_f32(stains, np.shape(stains))
    if m.ndim != 2 or m.shape[0] not in (2, 3) or m.shape[1] != 3:
        msg = f"stains must be [2, 3] or [3, 3], got shape {m.shape}."
        raise ValueError(msg)
    if tiles.device.type == "cpu":
        return stain_augment_reference(tiles, conc_proj, m, alpha, beta)
    if tiles.device.type != "cuda":
        msg = f"stain_augment runs on cpu or cuda tensors, got {tiles.device}."
        raise ValueError(msg)
    if not tiles.is_contiguous():
        msg = "tiles must be contiguous."
        raise ValueError(msg)
    s = m.shape[0]
    n = tiles.shape[0]
    a = _augment_factors(alpha, n, s, tiles.device, "alpha")
    b = _augment_factors(beta, n, s, tiles.device, "beta")
    coefs = augment_coefs(conc_proj, m)
    out = torch.empty_like(tiles)
    n_pix = tiles.numel() // 3
    if n_pix == 0:
        return out
    uniform = int(augment_path(tiles) == "tile_uniform")
    lib = _library()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        code = lib.stain_augment_u8(
            tiles.data_ptr(), out.data_ptr(), n_pix, n_pix // n, s, uniform, a.data_ptr(), b.data_ptr(), coefs, stream
        )
    if code != 0:
        msg = f"stain_augment_u8 failed: {lib.stain_error_string(code).decode()}"
        raise RuntimeError(msg)
    stain_augment.launches += 1
    return out


stain_augment.launches = 0
