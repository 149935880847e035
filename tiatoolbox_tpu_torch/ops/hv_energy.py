"""HoVer-Net watershed energy on the device: kernel K5.

Counterpart of ``tiatoolbox_tpu/ops/hv_energy.py:1-90``. The energy
landscape of the watershed (reference ``hovernet.py:503-617``): min-max
normalise the h and v direction maps, Sobel each (dx on h, dy on v, ksize
``int(20 * scale_factor) + 1``, BORDER_REFLECT_101), min-max normalise the
gradients and take ``max(1 - Sh, 1 - Sv)``.

- ``sobel_kernels`` (:26) computes OpenCV's integer Sobel taps
  (``getDerivKernels``) in Python, with OpenCV's own recurrence.
- ``hv_energy`` launches the kernel of ``csrc/hv_energy.cu`` on a CUDA map
  and runs ``hv_energy_reference`` on a CPU one: a reflected gather, two
  ``F.conv2d`` (1 x ksize along x, then ksize x 1 along y, the JAX order),
  ``amin``/``amax`` and the element-wise tail. The kernel sums the taps in
  another order than cuDNN or XLA; on [0, 1] the two agree within 2e-6
  (``chip_smoke.py`` and the ``cuda`` tests hold it to that).

The kernel makes three passes (min/max of the pair; a Sobel pass over tall
strips of 128 columns with the column window in registers, writing Sh and
Sv interleaved; the normalise-and-max tail), three launches, two where
``minmax`` is given. It is bound by device memory: it must read the pair
(8 B a pixel) and write the energy (4 B), and moves about 54 B a pixel
from a 4-channel canvas (the note in ``csrc/hv_energy.cu`` counts them).

``hv`` may be a strided ``[H, W, 2]`` view, such as channels 1:3 of a
``[H, W, C]`` canvas, as long as its channels are adjacent. With
``count`` (the canvas's ``[H, W, 1]`` hit count, or a view of it) ``hv``
is the raw accumulated canvas: the pair is divided by ``max(count, 1)`` as
it is loaded, the same IEEE division as ``normalize_rows`` (K3), so the
result equals ``normalize_rows`` followed by ``hv_energy`` and no
normalised copy of the canvas is made. With ``minmax`` (a float32 ``[4]``
tensor on ``hv``'s device, ``(min h, max h, min v, max v)`` of the
normalised pair, as ``pack_fg_tp`` reduces it from
the same canvas) the kernel skips its first pass, and the plain version
uses those values in place of its ``amin``/``amax``; the energy is the same
bits as without it when they are the pair's min and max. A CUDA map never
falls back to the plain version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tiatoolbox_tpu_torch import _build

SOURCE = "hv_energy.cu"
MAX_KSIZE = 31  # cv2's Sobel, which the JAX package calls for the taps, stops at 31
_OUT_DTYPES = (torch.float32, torch.float16)


@functools.cache
def sobel_kernels(ksize: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's separable Sobel taps for a first derivative: (derivative, smoothing), float32.

    ``cv2.getDerivKernels(1, 0, ksize, normalize=False)``, by the same
    integer recurrence as OpenCV's ``getSobelKernels``.
    """
    if ksize % 2 == 0 or ksize < 3:
        msg = f"ksize must be odd and at least 3, got {ksize}."
        raise ValueError(msg)

    def taps(order: int) -> np.ndarray:
        if ksize == 3:
            return np.array([[1, 2, 1], [-1, 0, 1]][order], np.float32)
        ker = [1] + [0] * ksize
        for _ in range(ksize - order - 1):
            old = ker[0]
            for j in range(1, ksize + 1):
                new = ker[j] + ker[j - 1]
                ker[j - 1] = old
                old = new
        for _ in range(order):
            old = -ker[0]
            for j in range(1, ksize + 1):
                new = ker[j - 1] - ker[j]
                ker[j - 1] = old
                old = new
        return np.array(ker[:ksize], np.float32)

    return taps(1), taps(0)


def reflect101_index(n: int, radius: int) -> np.ndarray:
    """Source indices of ``[-radius, n + radius)`` under BORDER_REFLECT_101,
    reflected as often as needed (OpenCV's ``borderInterpolate``, numpy's
    and ``jnp.pad``'s "reflect")."""
    idx = np.arange(-radius, n + radius)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its argument types set once per process."""
    lib = _build.load(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hv_energy_scratch_floats.argtypes = [i32, i32, i32, i32]
    lib.hv_energy_scratch_floats.restype = i64
    lib.hv_energy_launch.argtypes = [
        ptr, i64, i64, ptr, i64, i64, i32, i32, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr
    ]
    lib.hv_energy_launch.restype = i32
    lib.hv_energy_error_string.argtypes = [i32]
    lib.hv_energy_error_string.restype = ctypes.c_char_p
    return lib


def _ksize(scale_factor: float) -> int:
    ksize = int(20 * scale_factor) + 1
    if ksize > MAX_KSIZE:
        msg = f"scale_factor {scale_factor} gives ksize {ksize} > {MAX_KSIZE}."
        raise ValueError(msg)
    return ksize


def _check(hv: torch.Tensor, dtype, count: torch.Tensor | None, minmax: torch.Tensor | None) -> None:
    if hv.ndim != 3 or hv.shape[2] != 2:
        msg = f"hv must be [H, W, 2], got {tuple(hv.shape)}."
        raise ValueError(msg)
    if hv.dtype != torch.float32:
        msg = f"hv must be float32, got {hv.dtype}."
        raise ValueError(msg)
    if dtype not in _OUT_DTYPES:
        msg = f"Output dtype must be float32 or float16, got {dtype}."
        raise ValueError(msg)
    if count is not None and (
        tuple(count.shape) != (*hv.shape[:2], 1) or count.dtype != torch.float32 or count.device != hv.device
    ):
        msg = (
            f"count must be float32 [{hv.shape[0]}, {hv.shape[1]}, 1] on hv's device, "
            f"got {count.dtype} {tuple(count.shape)} on {count.device}."
        )
        raise ValueError(msg)
    if minmax is not None and (
        tuple(minmax.shape) != (4,) or minmax.dtype != torch.float32 or minmax.device != hv.device
    ):
        msg = (
            f"minmax must be float32 [4] on hv's device, "
            f"got {minmax.dtype} {tuple(minmax.shape)} on {minmax.device}."
        )
        raise ValueError(msg)


def _minmax(x: torch.Tensor, mn: torch.Tensor | None = None, mx: torch.Tensor | None = None) -> torch.Tensor:
    """``(x - min) / max(max - min, 1e-30)``, of x's own min and max unless given."""
    mn = x.amin() if mn is None else mn
    mx = x.amax() if mx is None else mx
    return (x - mn) / torch.clamp_min(mx - mn, 1e-30)


def _sep_conv(x: torch.Tensor, k_x: np.ndarray, k_y: np.ndarray) -> torch.Tensor:
    """Correlate along x with ``k_x``, then along y with ``k_y``, reflect-101 edges."""
    r = len(k_x) // 2
    h, w = x.shape
    iy = torch.from_numpy(reflect101_index(h, r)).to(x.device)
    ix = torch.from_numpy(reflect101_index(w, r)).to(x.device)
    padded = x.index_select(0, iy).index_select(1, ix)[None, None]
    kx = torch.from_numpy(k_x).to(x.device).view(1, 1, 1, -1)
    ky = torch.from_numpy(k_y).to(x.device).view(1, 1, -1, 1)
    return F.conv2d(F.conv2d(padded, kx), ky)[0, 0]


def hv_energy_reference(
    hv: torch.Tensor,
    scale_factor: float = 1.0,
    dtype=torch.float32,
    count: torch.Tensor | None = None,
    minmax: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: ``max(1 - minmax(Sobel_x(minmax h)), 1 - minmax(Sobel_y(minmax v)))``,
    of ``hv / max(count, 1)`` where ``count`` is given; ``minmax`` gives the
    min and max of h and v instead of their ``amin``/``amax``."""
    _check(hv, dtype, count, minmax)
    if count is not None:
        hv = hv / count.clamp_min(1.0)
    deriv, smooth = sobel_kernels(_ksize(scale_factor))
    h_range = v_range = ()
    if minmax is not None:
        h_range, v_range = (minmax[0], minmax[1]), (minmax[2], minmax[3])
    h_dir = _minmax(hv[..., 0], *h_range)
    v_dir = _minmax(hv[..., 1], *v_range)
    sobel_h = _minmax(_sep_conv(h_dir, deriv, smooth))
    sobel_v = _minmax(_sep_conv(v_dir, smooth, deriv))
    return torch.maximum(1.0 - sobel_h, 1.0 - sobel_v).to(dtype)


def hv_energy(
    hv: torch.Tensor,
    scale_factor: float = 1.0,
    dtype=torch.float32,
    count: torch.Tensor | None = None,
    minmax: torch.Tensor | None = None,
) -> torch.Tensor:
    """Watershed energy ``[H, W]`` of the hv maps ``[H, W, 2]``, as ``dtype``.

    With ``count`` (``[H, W, 1]``), ``hv`` is the raw accumulated canvas
    and is divided by ``max(count, 1)`` first. With ``minmax`` (float32
    ``[4]``: min h, max h, min v, max v of the divided pair) the min/max
    pass is skipped. ``hv_energy.launches`` counts kernel launches (one a
    call, whatever the passes).
    """
    _check(hv, dtype, count, minmax)
    if hv.device.type == "cpu":
        return hv_energy_reference(hv, scale_factor, dtype, count, minmax)
    if hv.device.type != "cuda":
        msg = f"hv_energy runs on cpu or cuda tensors, got {hv.device}."
        raise ValueError(msg)
    if hv.stride(2) != 1:
        msg = "hv's two channels must be adjacent in memory."
        raise ValueError(msg)
    if minmax is not None and (not minmax.is_contiguous() or minmax.data_ptr() % 16 != 0):
        msg = "minmax must be contiguous and 16-byte aligned."
        raise ValueError(msg)
    h, w = int(hv.shape[0]), int(hv.shape[1])
    out = torch.empty((h, w), dtype=dtype, device=hv.device)
    if out.numel() == 0:
        return out
    deriv, smooth = sobel_kernels(_ksize(scale_factor))
    lib = _library()
    with torch.cuda.device(hv.device):
        n_scratch = int(lib.hv_energy_scratch_floats(h, w, len(deriv), int(count is not None)))
        if n_scratch < 0:
            msg = f"hv_energy_scratch_floats failed for a {h}x{w} map and ksize {len(deriv)}."
            raise RuntimeError(msg)
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=hv.device)
        stream = torch.cuda.current_stream(hv.device).cuda_stream
        cnt_ptr, cnt_rs, cnt_ps = (0, 0, 0) if count is None else (count.data_ptr(), *count.stride()[:2])
        code = lib.hv_energy_launch(
            hv.data_ptr(), hv.stride(0), hv.stride(1), cnt_ptr, cnt_rs, cnt_ps, h, w,
            deriv.ctypes.data, smooth.ctypes.data, len(deriv), 0 if minmax is None else minmax.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), int(dtype == torch.float16), stream,
        )
    if code != 0:
        msg = f"hv_energy_launch failed: {lib.hv_energy_error_string(code).decode()}"
        raise RuntimeError(msg)
    hv_energy.launches += 1
    return out


hv_energy.launches = 0
