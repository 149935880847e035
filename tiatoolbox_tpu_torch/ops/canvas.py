"""Device canvas stitching: scatter-accumulate (K2), normalise (K3) and pack (K6).

Counterpart of ``tiatoolbox_tpu/ops/canvas.py:1-140``. Patch outputs are
added into a ``[H, W, C]`` float32 canvas and a ``[H, W, 1]`` hit count on
the device, then divided by the count.

- ``scatter_accumulate`` (:19-72) launches the CUDA kernel of
  ``csrc/canvas.cu`` on CUDA tensors and runs
  ``scatter_accumulate_reference``, a loop of slice additions in patch
  order, on CPU tensors. Both update ``canvas`` and ``count`` in place
  (the JAX program donates them) and equal each other bit for bit.
- ``normalize_rows`` is ``normalize_canvas`` (:77) fused with the crop and
  cast of ``semantic_segmentor.py:461-495``: rows ``[y0, y0+block_h)``,
  columns ``[0, width)``, cast to float32 or float16; the kernel of
  ``csrc/canvas.cu`` (K3) on CUDA, ``normalize_rows_reference`` on the CPU,
  equal bit for bit. K3 is bound by device memory; it moves 16-byte words
  (scalar heads and tails where the padded canvas's rows are not aligned)
  and loads each pixel's count once. The multitask engine's banded fetch
  does not call it: its energy (K5, ``ops/hv_energy.py``) reads the raw
  canvas and count and divides on load.
- ``pack_fg_tp`` is the multitask engine's pointwise fetch plane
  (``semantic_segmentor.py:461-495`` with HoVerNet's
  ``block_fetch_transform``, ``hovernet.py:662-672``): rows ``[0, h)`` and
  columns ``[0, w)`` of the count-normalised canvas packed as
  ``(np >= 0.5) | round(tp) << 1`` into uint8, the rounded type saturated
  to ``[0, 255]`` as JAX's ``astype(jnp.uint8)`` does. The same pass also
  gives the min and max of the normalised hv pair, channels 1 and 2 of
  HoVerNet's ``[np, h, v(, tp)]`` canvas (the first step of the watershed
  energy, ``ops/hv_energy.py:76-77``), as a float32 ``[4]`` tensor in K5's
  layout ``(min h, max h, min v, max v)``, which ``hv_energy(..., minmax=)``
  takes in place of its own first pass. The kernel of ``csrc/canvas.cu``
  (K6) on CUDA, ``pack_fg_tp_reference`` on the CPU, equal bit for bit
  (plane and min/max). K6 reads whole pixels (21 bytes a pixel of a
  4-channel canvas with the count) once; its min/max scratch is allocated
  per call and its ticket zeroed on the stream, as K5's.
- ``normalize_canvas``, ``canvas_argmax`` and ``DeviceCanvas`` (:88) keep
  the JAX API. ``DeviceCanvas.add`` marks patches that do not fit inside
  the canvas invalid, never clips them (:110-120).

Positions and validity flags are host data (numpy arrays or CPU tensors):
the wrapper places each position as ``dynamic_update_slice`` does (a
negative one counts from the end, then it is clamped into the canvas) and
passes the valid entries (y, x, patch index) to the kernel by value, in its
parameters: nothing is uploaded. A launch takes ``SCATTER_ENTRIES`` of them;
a longer batch is launched in chunks, in index order (``scatter_launches``).
A CUDA tensor never falls back to the plain version: the kernel
launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tiatoolbox_tpu_torch import _build, resolve_device

SOURCE = "canvas.cu"
# entries one K2 launch takes in its parameters (kScatterEntries in csrc/canvas.cu)
SCATTER_ENTRIES = 320


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its argument types set once per process."""
    lib = _build.load(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.canvas_scatter_accumulate.argtypes = [
        ptr, ptr, i64, i32, ptr, i32, i32, ptr, i32, i32, i32, i32, i32, ptr
    ]
    lib.canvas_scatter_accumulate.restype = i32
    lib.canvas_scatter_max_entries.restype = i32
    if lib.canvas_scatter_max_entries() != SCATTER_ENTRIES:
        msg = f"{SOURCE} takes {lib.canvas_scatter_max_entries()} entries a launch, not {SCATTER_ENTRIES}."
        raise RuntimeError(msg)
    lib.canvas_normalize_rows.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr, i32, ptr]
    lib.canvas_normalize_rows.restype = i32
    lib.canvas_pack_fg_tp.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.canvas_pack_fg_tp.restype = i32
    lib.canvas_pack_scratch_floats.restype = i32
    lib.canvas_error_string.argtypes = [i32]
    lib.canvas_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = f"{what} failed: {_library().canvas_error_string(code).decode()}"
        raise RuntimeError(msg)


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values)


def clamp_starts(starts: np.ndarray, shape_hw, patch_hw) -> np.ndarray:
    """(y, x) offsets as ``lax.dynamic_slice`` takes them: a negative offset
    counts from the end, then each is clamped so the patch lies inside.

    Raises:
        ValueError: the patch is larger than ``shape_hw``.
    """
    dims = np.array(shape_hw[:2], np.int64)
    hi = dims - np.array(patch_hw, np.int64)
    if np.any(hi < 0):
        msg = f"Patches of {tuple(patch_hw)} do not fit {tuple(shape_hw[:2])}."
        raise ValueError(msg)
    starts = np.asarray(starts, np.int64).reshape(-1, 2)
    return np.clip(np.where(starts < 0, starts + dims, starts), 0, hi)


def patch_table(positions, valid, canvas_hw, patch_hw) -> np.ndarray:
    """``[N, 4]`` int32 (y, x, valid, 0), each position placed inside the
    canvas (``clamp_starts``): the kernel's table, 16 bytes a patch.

    Raises:
        ValueError: a patch is larger than the canvas, or the shapes disagree.
    """
    pos = _host(positions).astype(np.int64).reshape(-1, 2)
    ok = _host(valid).astype(bool).reshape(-1)
    if len(ok) != len(pos):
        msg = f"{len(pos)} positions but {len(ok)} validity flags."
        raise ValueError(msg)
    zero = np.zeros_like(ok)
    return np.column_stack([clamp_starts(pos, canvas_hw, patch_hw), ok, zero]).astype(np.int32)


def scatter_launches(table: np.ndarray, patch_hw, chunk: int = SCATTER_ENTRIES) -> list:
    """K2's launches for a ``patch_table``: the valid entries as int32
    ``[k, 3]`` (y, x, patch index), in index order and at most ``chunk`` a
    launch, each with its union box ``(y0, x0, bh, bw)``."""
    ph, pw = patch_hw
    valid = np.flatnonzero(table[:, 2])
    launches = []
    for i in range(0, len(valid), chunk):
        sel = valid[i : i + chunk]
        ys, xs = table[sel, 0].astype(np.int64), table[sel, 1].astype(np.int64)
        entries = np.ascontiguousarray(np.column_stack([ys, xs, sel]), dtype=np.int32)
        y0, x0 = int(ys.min()), int(xs.min())
        launches.append((entries, (y0, x0, int(ys.max()) + ph - y0, int(xs.max()) + pw - x0)))
    return launches


def _check_canvas(canvas: torch.Tensor, count: torch.Tensor) -> None:
    if canvas.ndim != 3 or tuple(count.shape) != (*canvas.shape[:2], 1):
        msg = (
            f"canvas [H, W, C] and count [H, W, 1] expected, got "
            f"{tuple(canvas.shape)} and {tuple(count.shape)}."
        )
        raise ValueError(msg)
    if canvas.dtype != torch.float32 or count.dtype != torch.float32:
        msg = "canvas and count must be float32."
        raise ValueError(msg)
    if canvas.device != count.device:
        msg = "canvas and count must be on one device."
        raise ValueError(msg)


def _check_patches(canvas: torch.Tensor, count: torch.Tensor, patches: torch.Tensor) -> None:
    _check_canvas(canvas, count)
    if patches.ndim != 4 or patches.shape[-1] != canvas.shape[-1]:
        msg = f"patches [N, h, w, {canvas.shape[-1]}] expected, got {tuple(patches.shape)}."
        raise ValueError(msg)
    if patches.dtype != torch.float32 or patches.device != canvas.device:
        msg = "patches must be float32 and on the canvas's device."
        raise ValueError(msg)


def scatter_accumulate_reference(canvas, count, patches, positions, valid):
    """Plain version: for each valid patch in order, slice ``+=`` into canvas and count."""
    _check_patches(canvas, count, patches)
    ph, pw = patches.shape[1:3]
    table = patch_table(positions, valid, canvas.shape[:2], (ph, pw))
    for i, (y, x, ok, _) in enumerate(table.tolist()):
        if ok:
            canvas[y : y + ph, x : x + pw] += patches[i]
            count[y : y + ph, x : x + pw] += 1.0
    return canvas, count


def scatter_accumulate(canvas, count, patches, positions, valid):
    """Accumulate patches into ``(canvas, count)`` at ``positions``, in place.

    Args:
        canvas: ``[H, W, C]`` float32 accumulator.
        count: ``[H, W, 1]`` float32 hit counter.
        patches: ``[N, h, w, C]`` float32, on the canvas's device.
        positions: ``[N, 2]`` (y, x) top-left offsets, host data, placed
            inside the canvas as ``clamp_starts`` says.
        valid: ``[N]`` bools, host data; invalid entries add nothing.

    Returns:
        ``(canvas, count)``, the same tensors. ``scatter_accumulate.launches``
        counts kernel launches (one per ``SCATTER_ENTRIES`` valid entries).
    """
    _check_patches(canvas, count, patches)
    if canvas.device.type == "cpu":
        return scatter_accumulate_reference(canvas, count, patches, positions, valid)
    if canvas.device.type != "cuda":
        msg = f"scatter_accumulate runs on cpu or cuda tensors, got {canvas.device}."
        raise ValueError(msg)
    if not (canvas.is_contiguous() and count.is_contiguous() and patches.is_contiguous()):
        msg = "canvas, count and patches must be contiguous."
        raise ValueError(msg)
    ph, pw = patches.shape[1:3]
    table = patch_table(positions, valid, canvas.shape[:2], (ph, pw))
    lib = _library()
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        for entries, (y0, x0, bh, bw) in scatter_launches(table, (ph, pw)):
            code = lib.canvas_scatter_accumulate(
                canvas.data_ptr(), count.data_ptr(), canvas.shape[1], canvas.shape[2],
                patches.data_ptr(), ph, pw, entries.ctypes.data, len(entries), y0, x0, bh, bw, stream,
            )
            _raise_on(code, "canvas_scatter_accumulate")
            scatter_accumulate.launches += 1
    return canvas, count


scatter_accumulate.launches = 0

_OUT_DTYPES = (torch.float32, torch.float16)


def _check_rows(canvas, count, y0: int, block_h: int, width: int, dtype) -> None:
    _check_canvas(canvas, count)
    if dtype not in _OUT_DTYPES:
        msg = f"Output dtype must be float32 or float16, got {dtype}."
        raise ValueError(msg)
    h, w = canvas.shape[:2]
    if not (0 <= y0 and block_h >= 0 and y0 + block_h <= h and 0 <= width <= w):
        msg = f"Rows [{y0}, {y0 + block_h}) x columns [0, {width}) lie outside a {h}x{w} canvas."
        raise ValueError(msg)


def normalize_rows_reference(canvas, count, y0: int, block_h: int, width: int, dtype=torch.float32):
    """Plain version: ``(canvas / max(count, 1))[y0:y0+block_h, :width]`` cast to ``dtype``."""
    _check_rows(canvas, count, y0, block_h, width, dtype)
    rows = slice(y0, y0 + block_h)
    return (canvas[rows, :width] / count[rows, :width].clamp_min(1.0)).to(dtype)


def normalize_rows(canvas, count, y0: int, block_h: int, width: int, dtype=torch.float32):
    """Count-normalised rows ``[y0, y0+block_h)`` and columns ``[0, width)`` as ``dtype``.

    Returns a new ``[block_h, width, C]`` tensor on the canvas's device.
    ``normalize_rows.launches`` counts kernel launches.
    """
    _check_rows(canvas, count, y0, block_h, width, dtype)
    if canvas.device.type == "cpu":
        return normalize_rows_reference(canvas, count, y0, block_h, width, dtype)
    if canvas.device.type != "cuda":
        msg = f"normalize_rows runs on cpu or cuda tensors, got {canvas.device}."
        raise ValueError(msg)
    if not (canvas.is_contiguous() and count.is_contiguous()):
        msg = "canvas and count must be contiguous."
        raise ValueError(msg)
    out = torch.empty((block_h, width, canvas.shape[2]), dtype=dtype, device=canvas.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        code = lib.canvas_normalize_rows(
            canvas.data_ptr(), count.data_ptr(), canvas.shape[1], canvas.shape[2],
            int(y0), int(block_h), int(width), out.data_ptr(), int(dtype == torch.float16), stream,
        )
    _raise_on(code, "canvas_normalize_rows")
    normalize_rows.launches += 1
    return out


normalize_rows.launches = 0


def _check_pack(canvas, count, height: int, width: int, tp_channel: int) -> None:
    _check_canvas(canvas, count)
    h, w, c = canvas.shape
    if not (0 <= height <= h and 0 <= width <= w):
        msg = f"A {height}x{width} crop does not fit a {h}x{w} canvas."
        raise ValueError(msg)
    if c < 3:
        msg = f"A {c}-channel canvas has no hv pair in channels 1 and 2."
        raise ValueError(msg)
    if not -1 <= tp_channel < c:
        msg = f"Type channel {tp_channel} outside a {c}-channel canvas."
        raise ValueError(msg)


def _empty_minmax(device) -> torch.Tensor:
    """The min/max of no pixels: ``(inf, -inf, inf, -inf)``."""
    inf = float("inf")
    return torch.tensor([inf, -inf, inf, -inf], dtype=torch.float32, device=device)


def pack_fg_tp_reference(canvas, count, height: int, width: int, tp_channel: int = -1):
    """Plain version: ``fg | round(tp) << 1`` of the count-normalised crop, uint8
    ``[height, width, 1]``, and the ``amin``/``amax`` of the normalised
    channels 1 and 2, ``(min h, max h, min v, max v)``."""
    _check_pack(canvas, count, height, width, tp_channel)
    hits = count[:height, :width, 0].clamp_min(1.0)
    packed = (canvas[:height, :width, 0] / hits >= 0.5).to(torch.uint8)
    if tp_channel >= 0:
        tp = torch.round(canvas[:height, :width, tp_channel] / hits).clamp(0, 255).to(torch.uint8)
        packed = packed | (tp << 1)
    if packed.numel() == 0:
        return packed[..., None], _empty_minmax(canvas.device)
    h_dir, v_dir = (canvas[:height, :width, ch] / hits for ch in (1, 2))
    return packed[..., None], torch.stack([h_dir.amin(), h_dir.amax(), v_dir.amin(), v_dir.amax()])


def pack_fg_tp(canvas, count, height: int, width: int, tp_channel: int = -1):
    """Foreground bit and rounded type of the count-normalised crop, packed
    into uint8, and the min/max of the normalised hv pair.

    Args:
        canvas: ``[H, W, C]`` float32 accumulator, ``C >= 3``: channel 0 is
            the foreground probability (bit 0: ``>= 0.5``), channels 1 and 2
            the hv pair; count: ``[H, W, 1]``.
        height, width: the crop ``[0, height) x [0, width)``.
        tp_channel: channel of the type map (bits 1-7: ``round``, saturated
            to ``[0, 255]``), or -1.

    Returns:
        A new uint8 ``[height, width, 1]`` tensor on the canvas's device and
        a float32 ``[4]`` tensor ``(min h, max h, min v, max v)`` of the
        normalised pair (``(inf, -inf, inf, -inf)`` for an empty crop).
        ``pack_fg_tp.launches`` counts kernel launches.
    """
    _check_pack(canvas, count, height, width, tp_channel)
    if canvas.device.type == "cpu":
        return pack_fg_tp_reference(canvas, count, height, width, tp_channel)
    if canvas.device.type != "cuda":
        msg = f"pack_fg_tp runs on cpu or cuda tensors, got {canvas.device}."
        raise ValueError(msg)
    if not (canvas.is_contiguous() and count.is_contiguous()):
        msg = "canvas and count must be contiguous."
        raise ValueError(msg)
    out = torch.empty((height, width, 1), dtype=torch.uint8, device=canvas.device)
    if out.numel() == 0:
        return out, _empty_minmax(canvas.device)
    lib = _library()
    minmax = torch.empty(4, dtype=torch.float32, device=canvas.device)
    scratch = torch.empty(lib.canvas_pack_scratch_floats(), dtype=torch.float32, device=canvas.device)
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        code = lib.canvas_pack_fg_tp(
            canvas.data_ptr(), count.data_ptr(), canvas.shape[1], canvas.shape[2], int(tp_channel),
            int(height), int(width), out.data_ptr(), scratch.data_ptr(), minmax.data_ptr(), stream,
        )
    _raise_on(code, "canvas_pack_fg_tp")
    pack_fg_tp.launches += 1
    return out, minmax


pack_fg_tp.launches = 0


def normalize_canvas(canvas: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Divide the accumulated canvas by per-pixel hit counts (``canvas.py:77``)."""
    return normalize_rows(canvas, count, 0, canvas.shape[0], canvas.shape[1])


def canvas_argmax(canvas: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmax over channels as uint8 (``canvas.py:83``)."""
    return torch.argmax(canvas, dim=-1).to(torch.uint8)


def in_range_mask(positions, valid, canvas_hw, patch_hw) -> np.ndarray:
    """``DeviceCanvas.add``'s validity flags: a patch that does not fit
    inside the canvas is invalid (``canvas.py:101-120``). ``valid`` None
    means all valid. The scatter places the positions themselves."""
    h, w = canvas_hw
    ph, pw = patch_hw
    positions = _host(positions).astype(np.int64).reshape(-1, 2)
    valid = np.ones(len(positions), bool) if valid is None else _host(valid).astype(bool)
    in_range = (
        (positions[:, 0] >= 0)
        & (positions[:, 1] >= 0)
        & (positions[:, 0] + ph <= h)
        & (positions[:, 1] + pw <= w)
    )
    return valid & in_range


class DeviceCanvas:
    """Device-resident stitching canvas and hit count (``canvas.py:88``).

    Example:
        >>> canvas = DeviceCanvas((1024, 1024), n_channels=2, device="cpu")
        >>> canvas.add(patches, positions)      # [N,h,w,2], [N,2] (y,x)
        >>> probs = canvas.normalized()
    """

    def __init__(self, shape_hw: tuple[int, int], n_channels: int, device=None) -> None:
        dev = resolve_device(device)
        self.canvas = torch.zeros((*shape_hw, n_channels), dtype=torch.float32, device=dev)
        self.count = torch.zeros((*shape_hw, 1), dtype=torch.float32, device=dev)

    def add(self, patches: torch.Tensor, positions, valid=None) -> None:
        """Accumulate ``patches`` at ``positions`` (y, x); patches that do not
        fit inside the canvas are marked invalid, not clipped (``canvas.py:101-127``)."""
        patches = patches.to(self.canvas.device, torch.float32).contiguous()
        valid = in_range_mask(positions, valid, self.canvas.shape[:2], patches.shape[1:3])
        scatter_accumulate(self.canvas, self.count, patches, positions, valid)

    def normalized(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Count-normalised canvas, cast to ``dtype`` (float32 or float16) on the device."""
        h, w = self.canvas.shape[:2]
        return normalize_rows(self.canvas, self.count, 0, h, w, dtype or torch.float32)

    def predictions(self) -> torch.Tensor:
        """uint8 class map of the normalised canvas."""
        return canvas_argmax(self.normalized())
