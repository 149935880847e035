"""Colour conversions and the yuv420 wire (counterpart of ``tiatoolbox_tpu/ops/colorconv.py``).

- ``rgb2od`` (:16), ``od2rgb`` (:23) and ``rgb2grey`` (:29-34) on tensors.
  ``rgb2grey`` gives JAX's bits: ``fma(b, 0.114, fma(r, 0.299, g * 0.587))``
  in float32 (the operations XLA compiles JAX's sum into), rounded half to
  even. It is the device function's counterpart, not OpenCV's fixed point.
- The host pack ``rgb_batch_to_yuv420`` (:48) and ``rgb_image_to_yuv420``
  (:77), in numpy with OpenCV's integer arithmetic: 8-bit
  ``COLOR_RGB2YCrCb`` (``Y = (4899 R + 9617 G + 1868 B + 8192) >> 14``, Cr
  and Cb from ``R - Y`` and ``B - Y`` at 11682 and 9241 over 2^14, offset
  128, clipped) and ``INTER_AREA`` at half size (``(a + b + c + d + 2) >>
  2``), so the planes are JAX's cv2 pack byte for byte. The Cb plane comes
  before Cr.
- The unpack: ``yuv420_batch_to_rgb`` (:118) and ``unpack_yuv420_band`` (:95,
  the band program :107-115). On a CUDA tensor each launches kernel K8 of
  ``csrc/colorconv.cu`` through ``yuv420_to_rgb`` (its ``launches`` counts
  them); on a CPU tensor each runs its plain version
  (``yuv420_batch_to_rgb_reference``, ``unpack_yuv420_band_reference``),
  which evaluates K8's fused multiply-adds exactly in float64 and rounds to
  float32 where K8 rounds. The batch form can also divide by 255 in the
  same pass (``scale=True``, a multiply by ``float32(1 / 255)`` as XLA
  makes of JAX's ``/ 255.0``) and rounds once to the output type; JAX
  computes a bfloat16 unpack in bfloat16 throughout.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tiatoolbox_tpu_torch import _build

SOURCE = "colorconv.cu"

# K8's output modes (``Mode`` in csrc/colorconv.cu)
_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}

# the unpack's float32 constants, and JAX's float32 reciprocal of 255
_CR_R = np.float64(np.float32(1.403))
_CR_G = np.float64(np.float32(-0.714))
_CB_G = np.float64(np.float32(-0.344))
_CB_B = np.float64(np.float32(1.773))
INV_255 = float(np.float32(1.0 / 255.0))


def rgb2od(img) -> torch.Tensor:
    """uint8 RGB -> optical density; zeros are taken as 1 (JAX :16)."""
    img = torch.as_tensor(img)
    img = torch.where(img == 0, torch.ones_like(img), img).to(torch.float32)
    return torch.clamp(-torch.log(img / 255.0), min=1e-6)


def od2rgb(od) -> torch.Tensor:
    """Optical density -> uint8 RGB, truncated as JAX's cast (:23)."""
    od = torch.clamp(torch.as_tensor(od), min=1e-6)
    return (255.0 * torch.exp(-od)).to(torch.uint8)


def rgb2grey(img) -> torch.Tensor:
    """uint8 RGB ``[..., 3]`` -> uint8 grey with JAX's float32 BT.601 (:29-34)."""
    rgb = torch.as_tensor(img).to(torch.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    c = [float(np.float32(v)) for v in (0.299, 0.587, 0.114)]
    # float64 holds each product exactly: one rounding to float32 after each
    # sum is a fused multiply-add's
    t = (r * c[0] + (g * c[1]).to(torch.float32).to(torch.float64)).to(torch.float32)
    grey = (b * c[2] + t.to(torch.float64)).to(torch.float32)
    return torch.round(grey).to(torch.uint8)


# -- the host pack -------------------------------------------------------------------


def _half_area(plane: np.ndarray) -> np.ndarray:
    """OpenCV's uint8 ``INTER_AREA`` to half size: the rounded mean of each 2x2 block."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2]
    s += plane[1::2, 0::2]
    s += plane[1::2, 1::2]
    s += 2
    s >>= 2
    return s


# Y's weights: a pixel's weighted sum is at most 16384 x 255 < 2^24, so a
# float32 product exact in every term and partial sum gives it
_LUMA = np.array([4899, 9617, 1868], np.float32)
_CHROMA_OFFSET = (128 << 14) + 8192
_PACK_ROWS = 64  # rows packed at a time, a block that stays in the CPU's cache


def _pack_image(img: np.ndarray, out: np.ndarray) -> None:
    """Write one uint8 RGB ``[H, W, 3]`` image's planes into ``out`` ``[1.5 H, W]``."""
    h, w = img.shape[:2]
    quarter = h // 4
    cb_plane = out[h : h + quarter].reshape(h // 2, w // 2)
    cr_plane = out[h + quarter :].reshape(h // 2, w // 2)
    for r0 in range(0, h, _PACK_ROWS):
        block = img[r0 : r0 + _PACK_ROWS]
        r1 = r0 + block.shape[0]
        y = (block.astype(np.float32) @ _LUMA).astype(np.int32)
        y += 8192
        y >>= 14
        out[r0:r1] = y
        for channel, weight, plane in ((0, 11682, cr_plane), (2, 9241, cb_plane)):
            c = block[..., channel].astype(np.int32)
            c -= y
            c *= weight
            c += _CHROMA_OFFSET
            c >>= 14
            np.clip(c, 0, 255, out=c)
            plane[r0 // 2 : r1 // 2] = _half_area(c)


def rgb_batch_to_yuv420(batch, out: np.ndarray | None = None) -> np.ndarray:
    """Pack uint8 RGB ``[B, H, W, 3]`` -> uint8 planes ``[B, 1.5 H, W]`` (host).

    The layout is JAX's: the Y plane (H rows), then Cb, then Cr, each
    ``(H/2, W/2)`` stored row-major in ``H/4`` rows of width W. H must be a
    multiple of 4 and W of 2. ``out``, where given, receives the planes (a
    pinned buffer's numpy view, for instance).
    """
    batch = np.asarray(batch)
    n, h, w, _ = batch.shape
    if h % 4 or w % 2:
        msg = f"yuv420 wire format needs H%4==0 and W%2==0, got {h}x{w}."
        raise ValueError(msg)
    if out is None:
        out = np.empty((n, h + h // 2, w), np.uint8)
    elif out.shape != (n, h + h // 2, w) or out.dtype != np.uint8:
        msg = f"out must be uint8 {(n, h + h // 2, w)}, got {out.dtype} {out.shape}."
        raise ValueError(msg)
    for i in range(n):
        _pack_image(batch[i], out[i])
    return out


def rgb_image_to_yuv420(img) -> np.ndarray:
    """Pack one uint8 RGB ``[H, W, 3]`` image -> planes ``[1.5 H', W']`` (:77).

    The image is edge-padded up to ``H' % 4 == 0`` and ``W' % 2 == 0``;
    ``unpack_yuv420_band`` crops the pad off again.
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    ph, pw = (-h) % 4, (-w) % 2
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return rgb_batch_to_yuv420(img[None])[0]


# -- the unpack: plain versions ----------------------------------------------------


def _image_hw(planes_hw: tuple[int, int]) -> tuple[int, int]:
    h15, w = int(planes_hw[0]), int(planes_hw[1])
    h = (h15 * 2) // 3
    if h15 % 3 or h % 4 or w % 2:
        msg = f"yuv420 planes are [1.5 H, W] with H%4==0 and W%2==0, got {h15}x{w}."
        raise ValueError(msg)
    return h, w


def _unpack_float32(planes: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, 1.5 H, W]`` -> float32 ``[B, H, W, 3]`` clipped to 0..255, with
    K8's fused multiply-adds evaluated exactly in float64 and rounded to float32.

    Each chroma sample meets its 2x2 luma block by broadcasting over
    ``[B, H/2, 2, W/2, 2]``: no full-size chroma plane is made.
    """
    n = planes.shape[0]
    h, w = _image_hw(planes.shape[1:])
    quarter = h // 4
    blocks = (n, h // 2, 2, w // 2, 2)
    y = planes[:, :h].to(torch.float64).reshape(blocks)
    cb = planes[:, h : h + quarter].reshape(n, h // 2, 1, w // 2, 1).to(torch.float64) - 128.0
    cr = planes[:, h + quarter :].reshape(n, h // 2, 1, w // 2, 1).to(torch.float64) - 128.0
    r = (_CR_R * cr + y).to(torch.float32)
    g = (_CB_G * cb + (_CR_G * cr + y).to(torch.float32).to(torch.float64)).to(torch.float32)
    b = (_CB_B * cb + y).to(torch.float32)
    return torch.stack([r, g, b], dim=-1).clamp_(0.0, 255.0).reshape(n, h, w, 3)


def yuv420_batch_to_rgb_reference(
    planes: torch.Tensor, dtype: torch.dtype = torch.float32, *, scale: bool = False
) -> torch.Tensor:
    """Plain version of K8's batch entry: RGB ``[B, H, W, 3]`` in ``dtype``,
    times ``float32(1 / 255)`` first where ``scale``."""
    rgb = _unpack_float32(planes)
    if scale:
        rgb = rgb * INV_255
    return rgb.to(dtype)


def unpack_yuv420_band_reference(planes: torch.Tensor, band_hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of K8's band entry: uint8 ``[h, w, 3]``, rounded half to even."""
    rgb = _unpack_float32(planes[None])[0]
    return torch.round(rgb[: int(band_hw[0]), : int(band_hw[1])]).to(torch.uint8)


# -- the unpack: K8 ------------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its argument types set once per process."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.colorconv_yuv420_to_rgb.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, i32, ctypes.c_float, ptr]
    lib.colorconv_yuv420_to_rgb.restype = i32
    lib.colorconv_error_string.argtypes = [i32]
    lib.colorconv_error_string.restype = ctypes.c_char_p
    return lib


def yuv420_to_rgb(
    planes: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    *,
    scale: bool = False,
    band_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Launch K8 on CUDA uint8 planes.

    Args:
        planes: ``[B, 1.5 H, W]`` (batch) or ``[1.5 H, W]`` (band), contiguous
            uint8 at an even address (a view at any even offset will do: K8
            copies the 16-byte aligned cover of each row it reads).
        dtype: float32 or bfloat16 for a batch; a band is uint8.
        scale: multiply by ``float32(1 / 255)`` before the cast (batch).
        band_hw: the band's (h, w): selects the band entry.

    Returns:
        A new tensor on the planes' device (a fresh allocation, 16-byte
        aligned, as K8's 16-byte stores need). ``yuv420_to_rgb.launches``
        counts the launches.
    """
    if planes.device.type != "cuda":
        msg = f"yuv420_to_rgb launches K8 on a CUDA tensor, got {planes.device}."
        raise ValueError(msg)
    if planes.dtype != torch.uint8 or not planes.is_contiguous() or planes.data_ptr() % 2:
        msg = "K8 takes contiguous, 2-byte aligned uint8 planes."
        raise ValueError(msg)
    if band_hw is not None:
        if planes.ndim != 2:
            msg = f"A band's planes are [1.5 H, W], got shape {tuple(planes.shape)}."
            raise ValueError(msg)
        h, w = _image_hw(planes.shape)
        out_h, out_w = int(band_hw[0]), int(band_hw[1])
        if not (0 <= out_h <= h and 0 <= out_w <= w):
            msg = f"band_hw {band_hw} exceeds the planes' image {h}x{w}."
            raise ValueError(msg)
        n, mode, factor = 1, _MODES[torch.uint8], 1.0
        out = torch.empty((out_h, out_w, 3), dtype=torch.uint8, device=planes.device)
    else:
        if planes.ndim != 3 or dtype not in (torch.float32, torch.bfloat16):
            msg = f"A batch is [B, 1.5 H, W] unpacked to float32 or bfloat16, got {tuple(planes.shape)}, {dtype}."
            raise ValueError(msg)
        n = planes.shape[0]
        h, w = _image_hw(planes.shape[1:])
        out_h, out_w = h, w
        mode, factor = _MODES[dtype], INV_255 if scale else 1.0
        out = torch.empty((n, h, w, 3), dtype=dtype, device=planes.device)
    if out.numel() == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        code = lib.colorconv_yuv420_to_rgb(
            planes.data_ptr(), n, h, w, out.data_ptr(), mode, out_h, out_w, factor, stream
        )
    if code != 0:
        msg = f"colorconv_yuv420_to_rgb failed: {lib.colorconv_error_string(code).decode()}"
        raise RuntimeError(msg)
    yuv420_to_rgb.launches += 1
    return out


yuv420_to_rgb.launches = 0


def yuv420_batch_to_rgb(
    planes: torch.Tensor, dtype: torch.dtype = torch.float32, *, scale: bool = False
) -> torch.Tensor:
    """Unpack uint8 planes ``[B, 1.5 H, W]`` -> RGB ``[B, H, W, 3]`` in 0..255
    (times ``float32(1 / 255)`` where ``scale``), clipped, not rounded (:118).

    K8 on a CUDA tensor, the plain version on a CPU tensor.
    """
    if planes.device.type == "cpu":
        return yuv420_batch_to_rgb_reference(planes, dtype, scale=scale)
    return yuv420_to_rgb(planes, dtype, scale=scale)


def unpack_yuv420_band(planes: torch.Tensor, band_hw: tuple[int, int]) -> torch.Tensor:
    """One packed band ``[1.5 H', W']`` -> uint8 RGB ``[h, w, 3]`` cropped to
    ``band_hw`` (:95). K8 on a CUDA tensor, the plain version on a CPU tensor."""
    if planes.device.type == "cpu":
        return unpack_yuv420_band_reference(planes, band_hw)
    return yuv420_to_rgb(planes, band_hw=band_hw)
