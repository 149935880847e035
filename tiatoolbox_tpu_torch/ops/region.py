"""Region-once feed: ship a decoded slide band once, cut its patches on the device.

Counterpart of ``tiatoolbox_tpu/ops/region.py:1-193``. For an overlapping
patch grid (stride < patch) a per-patch feed ships every overlapped pixel
several times; a band feed ships each slide row once (plus a
(patch - stride)-row halo per band seam) and gathers the patches on the
device.

- ``BandPlan.build`` (:86-193) and ``Band`` are copied: a numpy planner
  whose plan equals the JAX one field by field.
- ``extract_patches`` (:42-58) gathers ``[B, ph, pw, C]`` patches from a
  ``[Hb, Wb, C]`` band: on a CUDA uint8 band the kernel of
  ``csrc/region.cu`` (K4), on a CPU band ``extract_patches_reference``.
  Start offsets are host data, placed as ``lax.dynamic_slice`` places them
  (``ops.canvas.clamp_starts``), and reach the kernel by value, as byte
  offsets in its parameters (``band_offsets``): nothing is uploaded. A
  launch takes ``EXTRACT_PATCHES`` patches; a longer batch is launched in
  chunks. A CUDA band never falls back to the plain version: the kernel
  launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from tiatoolbox_tpu_torch import _build
from tiatoolbox_tpu_torch.ops.canvas import clamp_starts

SOURCE = "region.cu"
# patches one K4 launch takes in its parameters (kExtractPatches in csrc/region.cu)
EXTRACT_PATCHES = 500


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its argument types set once per process."""
    lib = _build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.region_extract_patches.argtypes = [ptr, ctypes.c_int64, i32, ptr, i32, i32, i32, ptr, ptr]
    lib.region_extract_patches.restype = i32
    lib.region_extract_max_patches.restype = i32
    lib.region_empty_launch.argtypes = [i32, ptr]
    lib.region_empty_launch.restype = i32
    lib.region_error_string.argtypes = [i32]
    lib.region_error_string.restype = ctypes.c_char_p
    if lib.region_extract_max_patches() != EXTRACT_PATCHES:
        msg = f"{SOURCE} takes {lib.region_extract_max_patches()} patches a launch, not {EXTRACT_PATCHES}."
        raise RuntimeError(msg)
    return lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = f"{what} failed: {_library().region_error_string(code).decode()}"
        raise RuntimeError(msg)


def _starts(band: torch.Tensor, starts_yx, patch_hw) -> np.ndarray:
    """``[B, 2]`` int32 (y, x) offsets placed inside ``band`` as ``lax.dynamic_slice`` places them."""
    if band.ndim != 3:
        msg = f"A band is [H, W, C], got shape {tuple(band.shape)}."
        raise ValueError(msg)
    if isinstance(starts_yx, torch.Tensor):
        starts_yx = starts_yx.detach().cpu().numpy()
    return clamp_starts(starts_yx, band.shape, patch_hw).astype(np.int32)


def band_offsets(band_shape, starts: np.ndarray) -> np.ndarray:
    """int64 byte offset of each patch's first byte in a contiguous
    ``[H, W, C]`` band, for starts ``[B, 2]`` (y, x): K4's table."""
    _, w, c = band_shape
    starts = np.asarray(starts, np.int64).reshape(-1, 2)
    return (starts[:, 0] * int(w) + starts[:, 1]) * int(c)


def extract_patches_reference(band: torch.Tensor, starts_yx, patch_hw: tuple[int, int]) -> torch.Tensor:
    """Plain version: stack ``band[y:y+ph, x:x+pw]`` for each (y, x)."""
    ph, pw = int(patch_hw[0]), int(patch_hw[1])
    starts = _starts(band, starts_yx, (ph, pw))
    if len(starts) == 0:
        return band.new_empty((0, ph, pw, band.shape[2]))
    return torch.stack([band[y : y + ph, x : x + pw] for y, x in starts.tolist()])


def extract_patches(band: torch.Tensor, starts_yx, patch_hw: tuple[int, int]) -> torch.Tensor:
    """Gather ``[B, ph, pw, C]`` patches from a band on the device.

    Args:
        band: ``[H, W, C]`` tensor (uint8 on the wire; a CUDA band must be
            uint8 and contiguous).
        starts_yx: ``[B, 2]`` top-left (y, x) offsets, host data, placed
            inside the band as ``clamp_starts`` says.
        patch_hw: (height, width) of every patch.

    Returns:
        A new tensor on the band's device. ``extract_patches.launches``
        counts kernel launches (one per ``EXTRACT_PATCHES`` patches).
    """
    if band.device.type == "cpu":
        return extract_patches_reference(band, starts_yx, patch_hw)
    if band.device.type != "cuda":
        msg = f"extract_patches runs on cpu or cuda tensors, got {band.device}."
        raise ValueError(msg)
    if band.dtype != torch.uint8 or not band.is_contiguous():
        msg = f"A CUDA band must be contiguous uint8, got {band.dtype}."
        raise ValueError(msg)
    ph, pw = int(patch_hw[0]), int(patch_hw[1])
    starts = _starts(band, starts_yx, (ph, pw))
    out = torch.empty((len(starts), ph, pw, band.shape[2]), dtype=torch.uint8, device=band.device)
    if out.numel() == 0:
        return out
    offsets = band_offsets(band.shape, starts)
    lib = _library()
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream(band.device).cuda_stream
        for i in range(0, len(offsets), EXTRACT_PATCHES):
            part = np.ascontiguousarray(offsets[i : i + EXTRACT_PATCHES])
            code = lib.region_extract_patches(
                band.data_ptr(), band.shape[1], band.shape[2], part.ctypes.data,
                len(part), ph, pw, out[i].data_ptr(), stream,
            )
            _raise_on(code, "region_extract_patches")
            extract_patches.launches += 1
    return out


extract_patches.launches = 0


def launch_empty(device, with_args: bool = False) -> None:
    """Queue an empty kernel on ``device``'s current stream, with no
    parameters or with K4's 4 KB parameter struct: the floor under a launch,
    for timing beside the kernels."""
    device = torch.device(device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(_library().region_empty_launch(int(with_args), stream), "region_empty_launch")


@dataclass
class Band:
    """One horizontal slice of the read plan."""

    read_x: int  # band origin in read-resolution coords (may be <0)
    read_y: int
    band_w: int  # static read size (same for every band)
    band_h: int
    ds_indices: np.ndarray  # dataset indices of the patches in this band
    starts_local: np.ndarray  # [n, 2] int32 (y, x) offsets within the band


@dataclass
class BandPlan:
    """Band decomposition of a REGULAR patch grid.

    Eligibility is the caller's job in part (no mask-filtered holes if
    index reconstruction is to hold); :func:`BandPlan.build` returns
    None when the grid is not a complete x-fastest mesh or the bands
    would not beat the per-patch wire cost.
    """

    patch_h: int
    patch_w: int
    bands: list[Band] = field(default_factory=list)

    @property
    def wire_pixels(self) -> int:
        return sum(b.band_w * b.band_h for b in self.bands)

    @staticmethod
    def build(
        inputs: np.ndarray,
        patch_wh: tuple[int, int],
        stride_wh: tuple[int, int],
        max_band_bytes: int = 96 * 1024 * 1024,
        bytes_per_pixel: int = 3,
        min_bands: int = 6,
    ) -> "BandPlan | None":
        """Plan bands for the grid ``inputs`` ([x0, y0, x1, y1] rows).

        The grid must be the complete x-fastest meshgrid produced by
        ``PatchExtractor.get_coordinates`` (uniform patch size, uniform
        strides both axes). Returns None if it is not, or if banding
        would ship MORE pixels than the per-patch feed (stride >= patch:
        no overlap to save).

        ``min_bands`` targets a minimum band COUNT (not just a byte
        cap): a single band serializes decode→wire→dispatch→fetch
        (nothing to overlap), so the planner splits the grid into at
        least this many bands when there are enough patch rows — each
        extra band costs only a (patch-stride)-row halo re-read. The
        per-patch wire check below still rejects plans whose halos
        outweigh the overlap saving.
        """
        inputs = np.asarray(inputs)
        pw, ph = int(patch_wh[0]), int(patch_wh[1])
        sw, sh = int(stride_wh[0]), int(stride_wh[1])
        if len(inputs) == 0:
            return None
        sizes = inputs[:, 2:] - inputs[:, :2]
        if not np.all(sizes == (pw, ph)):
            return None
        xs = np.unique(inputs[:, 0])
        ys = np.unique(inputs[:, 1])
        if len(xs) * len(ys) != len(inputs):
            return None
        # complete x-fastest mesh with uniform strides
        if len(xs) > 1 and not np.all(np.diff(xs) == sw):
            return None
        if len(ys) > 1 and not np.all(np.diff(ys) == sh):
            return None
        expect = np.stack(
            [np.tile(xs, len(ys)), np.repeat(ys, len(xs))], axis=-1
        )
        if not np.array_equal(inputs[:, :2], expect):
            return None
        if sh >= ph and sw >= pw:
            return None  # no overlap: per-patch feed already ships once
        x_min = int(xs[0])
        band_w = int(xs[-1]) + pw - x_min
        n_cols = len(xs)
        # rows per band from the byte budget (>=1); every band reads the
        # same static (band_h, band_w) so one compiled program serves all
        rows_fit = max(
            1,
            (max_band_bytes // (band_w * bytes_per_pixel) - (ph - sh)) // sh,
        )
        # band count target: pipeline depth first, byte budget as a cap
        rows_target = (
            max(1, -(-len(ys) // max(1, int(min_bands))))
            if min_bands
            else len(ys)
        )

        def make_plan(rows_per_band: int) -> "BandPlan":
            band_h = (rows_per_band - 1) * sh + ph
            plan = BandPlan(patch_h=ph, patch_w=pw)
            for r0 in range(0, len(ys), rows_per_band):
                band_ys = ys[r0 : r0 + rows_per_band]
                read_y = int(band_ys[0])
                starts = []
                ds_idx = []
                for ri, y in enumerate(band_ys):
                    row = r0 + ri
                    for ci, x in enumerate(xs):
                        ds_idx.append(row * n_cols + ci)
                        starts.append((int(y) - read_y, int(x) - x_min))
                plan.bands.append(
                    Band(
                        read_x=x_min,
                        read_y=read_y,
                        band_w=band_w,
                        band_h=band_h,
                        ds_indices=np.asarray(ds_idx, np.int64),
                        starts_local=np.asarray(starts, np.int32),
                    )
                )
            return plan

        per_patch_pixels = len(inputs) * pw * ph
        for rows_per_band in dict.fromkeys(
            (
                min(int(rows_fit), len(ys), rows_target),
                min(int(rows_fit), len(ys)),
            )
        ):
            plan = make_plan(rows_per_band)
            # enforce the documented guarantee: never ship MORE pixels
            # than the per-patch feed (possible with one-axis overlap +
            # gaps on the other axis, or when min_bands halos outweigh
            # the overlap saving) — fall back to the byte-budget-maximal
            # plan before giving up entirely.
            if plan.wire_pixels < per_patch_pixels:
                return plan
        return None
