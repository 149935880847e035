"""Time the port's K2-K8 kernels against an earlier tree's, in turns, on one card.

    python3 scripts/kernel_ab.py --old DIR [--cases k2,k3,k4,k5,k6,k7,k8]

``DIR`` holds an earlier checkout's ``tiatoolbox_tpu_torch/csrc``, for
example from ``git archive <commit> tiatoolbox_tpu_torch/csrc | tar -x -C DIR``.
The script builds that tree's ``canvas.cu``, ``region.cu``,
``hv_energy.cu``, ``stain.cu`` and ``colorconv.cu`` with the port's nvcc flags into
``DIR/build``, and calls their C entries through ctypes with buffers made
once. The tree's kernels run through the port's wrappers. Shapes are
``chip_smoke.py``'s:

- K2 on the first region-feed batch of phase C (16 patches of 512x512x5 at
  stride 450 on the 4608x6362x5 canvas) and of phase D (32 patches of
  164x164x4 at stride 164 on a 3072x4100x4 canvas). The earlier tree's
  entry takes a device table (y, x, valid, 0); it is made once, and
  ``old_with_upload_ms`` also times the earlier wrapper's pinned upload of
  that table before each launch.
- K3 on phase C's canvas (4608 rows of 6362 pixels, 5 channels, the
  4608x6144 crop) and phase D's (3072 x 4100, 4 channels, the 3072x4096
  crop), float32 and float16 out.
- K4 on phase C's first band batch (16 patches of 1024x1024x3 from a
  1474x6874x3 band) and phase D's (32 patches of 256x256x3 from a
  748x4192x3 band); the earlier entry takes device starts (y, x), with the
  same ``old_with_upload_ms``.
- K5 on phase D's 4096x3072 map, from the normalised 4-channel canvas
  (channels 1:3) and, for the tree's kernel only, from the raw canvas with
  its count. The earlier entry is that of trees up to 4bb417d (no count).
- K6 on phase D's canvas (3072 x 4100, 4 channels, the 3072x4096 crop):
  the earlier tree's plane-only K6 against the tree's K6, which also
  gives the hv min/max; then the banded fetch's two kernels, the earlier
  K6 and K5's raw-canvas entry against the tree's K6 and K5 taking its
  min/max, compared bit for bit, and the spans of the tree's pair from a
  profiler trace. The earlier entries are those of ce2badd (K6 without
  the min/max, K5 without ``minmax``).
- K7 (stain augmentation, ``stain.cu`` ``stain_augment_u8``) on phase A's
  batch (64x224x224x3) and on all 2^24 colours (256 tiles of 256x256), at
  2 and 3 stains, with the row ``path`` the tree's wrapper took; K1 on the
  same batch beside it. The earlier entry is that of 007f1ea (no path
  argument). Then, for both trees' K7 kernels, what the compiler made:
  ``ptxas -v``'s registers and spills, and from ``cuobjdump -sass`` the
  instructions of each kernel's main loop (the loop with the most
  ``MUFU.EX2``, one a colour channel), its branches, and the kernel's
  ``CALL``s (a 64-bit division by a runtime value is one).
- K8 (the yuv420 unpack, ``colorconv.cu`` ``colorconv_yuv420_to_rgb``) at
  phase B's batch (64x224x224, float32 and bfloat16 out, divided by 255),
  phase C's first band (1474x6874 from planes padded to 1476 rows) and a
  ragged crop of it (1473x6871), each warm and with the L2 cache cold (a
  256 MB fill before each call, less the fill's own time), both in turns;
  the tree's per-launch device time from a ``utils.profiling.trace``
  window beside its event time, and the time of a fill of the output
  alone (``zero_``, the write half of the traffic); and for both trees' kernels ``ptxas -v``'s
  registers, spills and shared memory, and from ``cuobjdump -sass`` the
  global loads (``LDG``; ``LDGSTS``, cp.async into shared memory) and
  stores (``STG``) by width, 128-bit against narrower. The earlier entry
  is that of 5b4b39d (the same C signature).

The order of the runs is old, new, new, old; each is the mean of 20
back-to-back calls timed with CUDA events. The old and new outputs are
compared bit for bit. Last, where the tree's K5 spends its time: its three
passes, from a torch.profiler trace of 10 calls, as the spans between the
ends of consecutive kernels (the Sobel and combine passes may start before
the pass before them ends and wait for it, so their own spans overlap).
Prints the card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tiatoolbox_tpu_torch import _build  # noqa: E402
from tiatoolbox_tpu_torch.ops import canvas as canvas_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import colorconv  # noqa: E402
from tiatoolbox_tpu_torch.ops import hv_energy as energy_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import region as region_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import stain as stain_ops  # noqa: E402
from tiatoolbox_tpu_torch.utils import profiling  # noqa: E402

REPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# (canvas h, width, channels, patch side, stride, batch) of the first region-feed batch
K2_SHAPES = {"C": (4608, 6362, 5, 512, 450, 16), "D": (3072, 4100, 4, 164, 164, 32)}
# (band h, band w, patch side, stride, batch)
K4_SHAPES = {"C": (1474, 6874, 1024, 450, 16), "D": (748, 4192, 256, 164, 32)}
K7_BATCH = (64, 224, 224, 3)
HE = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]], np.float32)
K8_BATCH = (64, 224, 224)
K8_BAND = (1476, 6874)  # phase C's first band's planes: 1474 rows padded to a multiple of 4
# per pixel K8 reads 1.5 bytes of planes and writes 3 values
K8_BYTES_PER_PIX = {torch.float32: 13.5, torch.bfloat16: 7.5, torch.uint8: 4.5}
HED = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]], np.float32)


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_old(old: Path, source: str) -> ctypes.CDLL:
    csrc = old / "tiatoolbox_tpu_torch" / "csrc"
    out = old / "build" / f"lib{Path(source).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the old {source}:\n{proc.stderr}")
    out.with_suffix(".ptxas").write_text(proc.stderr)
    return ctypes.CDLL(str(out))


def in_turns(old, new) -> dict:
    """Times of ``old`` and ``new`` in the order old, new, new, old."""
    t = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
    return {"old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]]}


def grid_batch(width: int, side: int, stride: int, batch: int) -> np.ndarray:
    """The first ``batch`` (y, x) of an x-fastest grid at ``stride`` whose
    ``side``-wide patches fit ``width``."""
    cols = (width - side) // stride + 1
    return np.array([[(i // cols) * stride, (i % cols) * stride] for i in range(batch)], np.int32)


def covered(hw, pos: np.ndarray, side: int) -> int:
    mask = np.zeros(hw, bool)
    for y, x in pos.tolist():
        mask[y : y + side, x : x + side] = True
    return int(mask.sum())


def upload(host: np.ndarray) -> torch.Tensor:
    """The earlier wrappers' table upload: pinned, then copied on the stream."""
    return torch.from_numpy(host).pin_memory().to("cuda", non_blocking=True)


def k2_cases(lib: ctypes.CDLL, gen: torch.Generator) -> list[dict]:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.canvas_scatter_accumulate.argtypes = [ptr, ptr, i64, i32, ptr, i32, i32, i32, ptr, i32, i32, i32, i32, ptr]
    rows = []
    for phase, (h, width, c, side, stride, batch) in K2_SHAPES.items():
        pos = grid_batch(width, side, stride, batch)
        ok = np.ones(batch, bool)
        table = canvas_ops.patch_table(pos, ok, (h, width), (side, side))
        table_dev = torch.from_numpy(table).cuda()
        y0, x0 = pos.min(axis=0).tolist()
        bh, bw = (pos.max(axis=0) + side - (y0, x0)).tolist()
        patches = torch.rand((batch, side, side, c), generator=gen, device="cuda")
        start = torch.rand((h, width, c), generator=gen, device="cuda")
        start_n = torch.randint(0, 3, (h, width, 1), generator=gen, device="cuda").float()
        old_c, old_n, new_c, new_n = start.clone(), start_n.clone(), start.clone(), start_n.clone()

        def old(table_dev=table_dev, c=old_c, n=old_n, patches=patches, y0=y0, x0=x0, bh=bh, bw=bw):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.canvas_scatter_accumulate(c.data_ptr(), n.data_ptr(), c.shape[1], c.shape[2],
                                                 patches.data_ptr(), len(table), patches.shape[1], patches.shape[2],
                                                 table_dev.data_ptr(), y0, x0, bh, bw, stream)
            assert code == 0, code

        def old_with_upload(table=table, old=old):
            old(table_dev=upload(table))

        def new(c=new_c, n=new_n, patches=patches, pos=pos, ok=ok):
            canvas_ops.scatter_accumulate(c, n, patches, pos, ok)

        old()
        new()
        torch.cuda.synchronize()
        same = bool(torch.equal(old_c, new_c) and torch.equal(old_n, new_n))
        area = covered((h, width), pos, side)
        n_bytes = batch * side * side * c * 4 + area * (c + 1) * 4 * 2 + batch * 16
        row = {"kernel": "K2 scatter_accumulate", "phase": phase, "patches": [batch, side, side, c],
               "canvas": [h, width, c], "covered_pixels": area, "bytes": n_bytes,
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "identical": same, **in_turns(old, new)}
        row["old_with_upload_ms"] = [time_ms(old_with_upload), time_ms(old_with_upload)]
        rows.append(row)
        del patches, start, start_n, old_c, old_n, new_c, new_n
    return rows


def k4_cases(lib: ctypes.CDLL, gen: torch.Generator) -> list[dict]:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.region_extract_patches.argtypes = [ptr, ctypes.c_int64, i32, ptr, i32, i32, i32, ptr, ptr]
    rows = []
    for phase, (bh, bw, side, stride, batch) in K4_SHAPES.items():
        band = torch.randint(0, 256, (bh, bw, 3), generator=gen, device="cuda", dtype=torch.uint8)
        starts = grid_batch(bw, side, stride, batch)
        starts_dev = torch.from_numpy(starts).cuda()
        out = torch.empty((batch, side, side, 3), dtype=torch.uint8, device="cuda")

        def old(starts_dev=starts_dev, band=band, out=out, side=side):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.region_extract_patches(band.data_ptr(), band.shape[1], 3, starts_dev.data_ptr(),
                                              len(starts_dev), side, side, out.data_ptr(), stream)
            assert code == 0, code

        def old_with_upload(starts=starts, old=old):
            old(starts_dev=upload(starts))

        def new(band=band, starts=starts, side=side):
            return region_ops.extract_patches(band, starts, (side, side))

        old()
        same = bool(torch.equal(out, new()))
        area = covered((bh, bw), starts, side)
        n_bytes = area * 3 + batch * side * side * 3 + batch * 8
        row = {"kernel": "K4 extract_patches", "phase": phase, "patches": [batch, side, side, 3],
               "band": [bh, bw, 3], "covered_band_pixels": area, "bytes": n_bytes,
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "identical": same, **in_turns(old, new)}
        row["old_with_upload_ms"] = [time_ms(old_with_upload), time_ms(old_with_upload)]
        rows.append(row)
        del band, out
    return rows


def k3_cases(lib: ctypes.CDLL, gen: torch.Generator) -> list[dict]:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.canvas_normalize_rows.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr, i32, ptr]
    rows = []
    for phase, (h, width, c, w) in {"C": (4608, 6362, 5, 6144), "D": (3072, 4100, 4, 4096)}.items():
        cv = torch.rand((h, width, c), generator=gen, device="cuda")
        cn = torch.randint(0, 4, (h, width, 1), generator=gen, device="cuda").float()
        for dtype in (torch.float32, torch.float16):
            out = torch.empty((h, w, c), dtype=dtype, device="cuda")

            def old(out=out, cv=cv, cn=cn, h=h, w=w, dtype=dtype):
                stream = torch.cuda.current_stream().cuda_stream
                code = lib.canvas_normalize_rows(cv.data_ptr(), cn.data_ptr(), cv.shape[1], cv.shape[2],
                                                 0, h, w, out.data_ptr(), int(dtype == torch.float16), stream)
                assert code == 0, code

            def new(cv=cv, cn=cn, h=h, w=w, dtype=dtype):
                return canvas_ops.normalize_rows(cv, cn, 0, h, w, dtype)

            old()
            same = bool(torch.equal(out, new()))
            n_bytes = h * w * (c + 1) * 4 + h * w * c * out.element_size()
            rows.append({"kernel": "K3 normalize_rows", "phase": phase, "shape": [h, w, c], "canvas_width": width,
                         "dtype": str(dtype), "bytes": n_bytes, "identical": same, **in_turns(old, new)})
        del cv, cn
    return rows


def k5_cases(lib: ctypes.CDLL, gen: torch.Generator) -> list[dict]:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hv_energy_scratch_floats.argtypes = [i32, i32]
    lib.hv_energy_scratch_floats.restype = i64
    lib.hv_energy_launch.argtypes = [ptr, i64, i32, i32, i32, ptr, ptr, i32, ptr, ptr, i32, ptr]
    h, width, w = 3072, 4100, 4096
    canvas = torch.rand((h, width, 4), generator=gen, device="cuda") * 2 - 1
    count = torch.randint(1, 4, (h, width, 1), generator=gen, device="cuda").float()
    canvas *= count
    view = canvas_ops.normalize_rows(canvas, count, 0, h, w)[..., 1:3]
    deriv, smooth = energy_ops.sobel_kernels(21)
    scratch = torch.empty(int(lib.hv_energy_scratch_floats(h, w)), device="cuda")
    rows = []
    for dtype in (torch.float32, torch.float16):
        out = torch.empty((h, w), dtype=dtype, device="cuda")

        def old(out=out, dtype=dtype):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.hv_energy_launch(view.data_ptr(), view.stride(0), view.stride(1), h, w,
                                        deriv.ctypes.data, smooth.ctypes.data, 21, scratch.data_ptr(),
                                        out.data_ptr(), int(dtype == torch.float16), stream)
            assert code == 0, code

        def new(dtype=dtype):
            return energy_ops.hv_energy(view, dtype=dtype)

        def new_raw(dtype=dtype):
            return energy_ops.hv_energy(canvas[:h, :w, 1:3], dtype=dtype, count=count[:h, :w])

        old()
        got = new()
        raw = new_raw()
        row = {"kernel": "K5 hv_energy", "phase": "D", "shape": [h, w], "dtype": str(dtype),
               "identical": bool(torch.equal(out, got)), "raw_entry_identical": bool(torch.equal(raw, got)),
               **in_turns(old, new)}
        row["raw_entry_ms"] = [time_ms(new_raw), time_ms(new_raw)]
        rows.append(row)
    rows.append({"kernel": "K5 passes", "phase": "D", "dtype": "torch.float32",
                 "view_ms": energy_passes(lambda: energy_ops.hv_energy(view)),
                 "raw_entry_ms": energy_passes(lambda: energy_ops.hv_energy(canvas[:h, :w, 1:3], count=count[:h, :w]))})
    return rows


def energy_passes(fn, first: str = "hv_minmax") -> dict:
    """Median spans (ms) of the kernel named ``first`` (K5's min/max pass, or
    K6 where it gives the min/max) and K5's Sobel and combine passes after
    it, over 10 calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    spans = {"minmax": [], "sobel": [], "combine": []}
    for i, e in enumerate(kernels):
        if first in e["name"] and i + 2 < len(kernels):
            ends = [k["ts"] + k["dur"] for k in kernels[i : i + 3]]
            spans["minmax"].append(ends[0] - e["ts"])
            spans["sobel"].append(ends[1] - ends[0])
            spans["combine"].append(ends[2] - ends[1])
    return {name: statistics.median(v) / 1e3 for name, v in spans.items() if v}


def k6_cases(libs: dict, gen: torch.Generator) -> list[dict]:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    old_canvas, old_energy = libs["canvas.cu"], libs["hv_energy.cu"]
    old_canvas.canvas_pack_fg_tp.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr]
    old_energy.hv_energy_scratch_floats.argtypes = [i32, i32, i32, i32]
    old_energy.hv_energy_scratch_floats.restype = i64
    old_energy.hv_energy_launch.argtypes = [ptr, i64, i64, ptr, i64, i64, i32, i32, ptr, ptr, i32, ptr, ptr, i32, ptr]
    h, width, w = 3072, 4100, 4096
    count = torch.randint(0, 3, (h, width, 1), generator=gen, device="cuda").float()
    canvas = torch.rand((h, width, 4), generator=gen, device="cuda")
    canvas[..., 1:3] = canvas[..., 1:3] * 2 - 1
    canvas[..., 3] = torch.randint(0, 6, (h, width), generator=gen, device="cuda").float()
    canvas *= count.clamp_min(1)
    plane_old = torch.empty((h, w, 1), dtype=torch.uint8, device="cuda")
    energy_old = torch.empty((h, w), device="cuda")
    deriv, smooth = energy_ops.sobel_kernels(21)
    scratch = torch.empty(int(old_energy.hv_energy_scratch_floats(h, w, 21, 1)), device="cuda")
    raw, raw_count = canvas[:h, :w, 1:3], count[:h, :w]

    def old_k6():
        stream = torch.cuda.current_stream().cuda_stream
        code = old_canvas.canvas_pack_fg_tp(canvas.data_ptr(), count.data_ptr(), width, 4, 3, h, w,
                                            plane_old.data_ptr(), stream)
        assert code == 0, code

    def old_pair():
        old_k6()
        stream = torch.cuda.current_stream().cuda_stream
        code = old_energy.hv_energy_launch(raw.data_ptr(), raw.stride(0), raw.stride(1), raw_count.data_ptr(),
                                           raw_count.stride(0), raw_count.stride(1), h, w, deriv.ctypes.data,
                                           smooth.ctypes.data, 21, scratch.data_ptr(), energy_old.data_ptr(), 0,
                                           stream)
        assert code == 0, code

    def new_k6():
        return canvas_ops.pack_fg_tp(canvas, count, h, w, 3)

    def new_pair():
        plane, minmax = new_k6()
        return plane, energy_ops.hv_energy(raw, count=raw_count, minmax=minmax)

    old_pair()
    plane, energy = new_pair()
    torch.cuda.synchronize()
    n_pix = h * w
    row = {"kernel": "K6 pack_fg_tp", "phase": "D", "shape": [h, w, 4], "canvas_width": width,
           "bytes": 21 * n_pix, "bound_ms": 21 * n_pix / HBM_BYTES_PER_S * 1e3,
           "plane_bound_13b_ms": 13 * n_pix / HBM_BYTES_PER_S * 1e3,
           "identical": bool(torch.equal(plane, plane_old)), **in_turns(old_k6, new_k6)}
    pair = {"kernel": "K6 + K5 banded fetch", "phase": "D", "shape": [h, w],
            "identical": bool(torch.equal(energy, energy_old)), **in_turns(old_pair, new_pair),
            "new_spans_ms": energy_passes(new_pair, first="pack_kernel")}
    return [row, pair]


def kernel_name(mangled: str) -> str:
    """``_Z26stain_augment_tiles_kernelILi2EE...`` -> ``stain_augment_tiles_kernel<2>``;
    a kernel in an anonymous namespace,
    ``_ZN45_GLOBAL__N__<hash>13yuv420_kernelILi0ELi252ELb1EEE...`` -> ``yuv420_kernel<0,252,1>``."""
    nested = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    start = 3 + len(nested.group(1)) + int(nested.group(1)) if nested else 2
    size = re.match(r"\d+", mangled[start:]) if mangled.startswith("_Z") else None
    if not size:
        return mangled
    start += size.end()
    name = mangled[start : start + int(size.group(0))]
    template = re.match(r"I((?:L[a-z]-?\d+E)+)E", mangled[start + len(name) :])
    return f"{name}<{','.join(re.findall(r'L[a-z](-?\d+)E', template.group(1)))}>" if template else name


def ptxas_kernels(lines: list[str], name: str) -> dict:
    """Registers and spills ``ptxas -v`` gave each kernel whose name holds
    ``name``, keyed by the kernel's name and its stain count."""
    found, current = {}, None
    for line in lines:
        if "entry function" in line:
            entry = kernel_name(line.split("'")[1])
            current = entry if name in entry else None
            continue
        if current is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        smem = re.search(r"(\d+) bytes smem", line)
        if regs:
            found.setdefault(current, {})["registers"] = int(regs.group(1))
        if smem:
            found.setdefault(current, {})["static_smem_bytes"] = int(smem.group(1))
        if spill:
            found.setdefault(current, {})["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
    return found


SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")


def opcode(insn: str) -> str:
    return re.sub(r"^@!?U?P[T\d]+\s+", "", insn).split()[0]


def sass_loops(library: Path, name: str) -> dict:
    """From ``cuobjdump -sass``: for each kernel whose name holds ``name``, its
    instructions and CALLs, and its main loop (the range of a predicated
    backward branch with the most MUFU.EX2, the smallest of equals):
    instructions (NOPs left out), MUFU.EX2 (one a colour channel of a pixel),
    instructions a pixel, BRA, CALL."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"cuobjdump": "not available"}
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    found, insns, labels, pending, current = {}, [], {}, [], None

    def close() -> None:
        if current is None:
            return
        ops = [(a, opcode(t), t) for a, t in insns if opcode(t) != "NOP"]
        loops = []
        for addr, op, t in ops:
            target = re.search(r"\(?(\.L_x_\d+|0x[0-9a-f]+)\)?\s*$", t)
            # a loop's back edge is a predicated branch (out-of-line code jumps back unpredicated)
            if not op.startswith("BRA") or not t.startswith("@") or not target:
                continue
            key = target.group(1)
            start = labels.get(key, int(key, 16) if key.startswith("0x") else None)
            if start is not None and start <= addr:
                body = [o for a, o, _ in ops if start <= a <= addr]
                ex2 = sum(o == "MUFU.EX2" for o in body)
                loops.append({"instructions": len(body), "mufu_ex2": ex2,
                              "instructions_per_pixel": 3 * len(body) / ex2 if ex2 else None,
                              "bra": sum(o.startswith("BRA") for o in body), "call": sum(o.startswith("CALL") for o in body)})
        main = max(loops, key=lambda lp: (lp["mufu_ex2"], -lp["instructions"]), default=None)
        listing = "\n".join(t for _, t in insns).encode()
        found[current] = {"instructions": len(ops), "calls": sum(o.startswith("CALL") for _, o, _ in ops),
                          "main_loop": main, "sha256": hashlib.sha256(listing).hexdigest()[:16]}

    for line in text.splitlines():
        if "Function :" in line:
            close()
            entry = kernel_name(line.split("Function :")[1].strip())
            current = entry if name in entry else None
            insns, labels, pending = [], {}, []
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        insn = SASS_INSN.search(line)
        if insn:
            addr = int(insn.group(1), 16)
            labels.update(dict.fromkeys(pending, addr))
            pending = []
            insns.append((addr, insn.group(2)))
    close()
    return found


def k7_cases(lib: ctypes.CDLL, old_dir: Path, gen: torch.Generator) -> list[dict]:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.stain_augment_u8.argtypes = [ptr, ptr, i64, i64, i32, ptr, ptr, stain_ops.AugmentCoefs, ptr]
    batch = torch.from_numpy(np.random.default_rng(17).integers(0, 256, K7_BATCH, dtype=np.uint8)).cuda()
    c = torch.arange(1 << 24, dtype=torch.int32, device="cuda")
    colours = torch.stack([c >> 16, (c >> 8) & 255, c & 255], -1).to(torch.uint8).reshape(256, 256, 256, 3)
    rows = []
    for what, tiles in (("64x224x224x3", batch), ("2^24 colours", colours)):
        n, n_pix = tiles.shape[0], tiles.numel() // 3
        for stains in (HE, HED):
            s = len(stains)
            alpha = torch.rand((n, s), generator=gen, device="cuda") * 0.8 + 0.6
            beta = torch.rand((n, s), generator=gen, device="cuda") * 0.4 - 0.2
            proj = np.linalg.pinv(stains.T).T.astype(np.float32)
            coefs = stain_ops.augment_coefs(proj, stains)
            out = torch.empty_like(tiles)

            def old(tiles=tiles, out=out, n=n, n_pix=n_pix, s=s, alpha=alpha, beta=beta, coefs=coefs):
                stream = torch.cuda.current_stream().cuda_stream
                code = lib.stain_augment_u8(tiles.data_ptr(), out.data_ptr(), n_pix, n_pix // n, s,
                                            alpha.data_ptr(), beta.data_ptr(), coefs, stream)
                assert code == 0, code

            def new(tiles=tiles, proj=proj, stains=stains, alpha=alpha, beta=beta):
                return stain_ops.stain_augment(tiles, proj, stains, alpha, beta)

            old()
            same = bool(torch.equal(out, new()))
            n_bytes = 6 * n_pix
            rows.append({"kernel": "K7 stain_augment", "input": what, "stains": s,
                         "path": stain_ops.augment_path(tiles), "bytes": n_bytes,
                         "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "identical": same, **in_turns(old, new)})
    proj, scale = np.linalg.pinv(HE.T).T.astype(np.float32), np.ones(2, np.float32)
    rows.append({"kernel": "K1 stain_transform", "input": "64x224x224x3", "stains": 2,
                 "ms": [time_ms(lambda: stain_ops.stain_transform(batch, proj, HE, scale)) for _ in range(2)]})
    old_so = old_dir / "build" / "libstain.so"
    new_so = _build.library_path("stain.cu")
    old_sass, new_sass = sass_loops(old_so, "stain"), sass_loops(new_so, "stain")
    k1 = "stain_transform_kernel"
    rows.append({"kernel": "K7 compiled", "old": {"ptxas": ptxas_kernels(old_so.with_suffix(".ptxas").read_text().splitlines(), "stain"),
                                                  "sass": old_sass},
                 "new": {"ptxas": ptxas_kernels(_build.ptxas_report("stain.cu"), "stain"), "sass": new_sass},
                 "k1_sass_identical": k1 in old_sass and old_sass[k1].get("sha256") == new_sass.get(k1, {}).get("sha256")})
    return rows


def access_width(op: str) -> str:
    """The bits one lane moves in a global load or store: ``LDG.E.128`` -> "128",
    ``STG.E.U8`` -> "8", ``LDG.E`` -> "32"."""
    for width in ("128", "64", "16", "8"):
        if re.search(rf"\.[US]?{width}\b", op):
            return width
    return "32"


def sass_global_access(library: Path, name: str) -> dict:
    """From ``cuobjdump -sass``: for each kernel whose name holds ``name``, its
    global loads (``LDG``), copies into shared memory (``LDGSTS``) and global
    stores (``STG``), counted by the bits a lane moves."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"cuobjdump": "not available"}
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    found, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            entry = kernel_name(line.split("Function :")[1].strip())
            current = entry if name in entry else None
            if current:
                found[current] = {"LDG": {}, "LDGSTS": {}, "STG": {}}
            continue
        insn = SASS_INSN.search(line)
        if current is None or not insn:
            continue
        op = opcode(insn.group(2))
        kind = op.split(".")[0]
        if kind in found[current]:
            counts = found[current][kind]
            width = access_width(op)
            counts[width] = counts.get(width, 0) + 1
    return found


def cold_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn()`` with the 50 MB L2 cache cold: ``time_ms`` of a
    256 MB fill then ``fn()``, less that of the fill alone."""
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    return time_ms(lambda: (scrub.zero_(), fn()), reps) - time_ms(scrub.zero_, reps)


def trace_ms(fn, name: str, reps: int = REPS) -> float:
    """Mean device time of the kernels whose name holds ``name`` over ``reps``
    calls of ``fn`` in a ``utils.profiling.trace`` window."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for _ in range(reps):
                fn()
        events = json.loads((Path(tmp) / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = [e["dur"] for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
    return statistics.mean(spans) / 1e3 if spans else float("nan")


def k8_cases(lib: ctypes.CDLL, old_dir: Path) -> list[dict]:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.colorconv_yuv420_to_rgb.argtypes = [ptr, i32, i32, i32, ptr, i32, i32, i32, ctypes.c_float, ptr]
    lib.colorconv_yuv420_to_rgb.restype = i32
    rng = np.random.default_rng(24)
    rgb = rng.integers(0, 256, (*K8_BATCH, 3), dtype=np.uint8)
    batch = torch.from_numpy(colorconv.rgb_batch_to_yuv420(rgb)).cuda()
    band_h, band_w = K8_BAND
    band = torch.from_numpy(rng.integers(0, 256, (band_h * 3 // 2, band_w), dtype=np.uint8)).cuda()
    cases = [("B batch", batch, torch.float32, None), ("B batch", batch, torch.bfloat16, None),
             ("C first band", band, torch.uint8, (1474, 6874)), ("ragged band crop", band, torch.uint8, (1473, 6871))]
    rows = []
    for what, planes, dtype, band_hw in cases:
        h, w = planes.shape[-2] * 2 // 3, planes.shape[-1]
        n = planes.shape[0] if planes.ndim == 3 else 1
        out_h, out_w = band_hw or (h, w)
        mode = colorconv._MODES[dtype]
        factor = colorconv.INV_255 if band_hw is None else 1.0
        out = torch.empty((n, out_h, out_w, 3) if band_hw is None else (out_h, out_w, 3), dtype=dtype, device="cuda")

        def old(planes=planes, n=n, h=h, w=w, out=out, mode=mode, out_h=out_h, out_w=out_w, factor=factor):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.colorconv_yuv420_to_rgb(planes.data_ptr(), n, h, w, out.data_ptr(), mode, out_h, out_w,
                                               factor, stream)
            assert code == 0, code

        def new(planes=planes, dtype=dtype, band_hw=band_hw):
            if band_hw is None:
                return colorconv.yuv420_to_rgb(planes, dtype, scale=True)
            return colorconv.yuv420_to_rgb(planes, band_hw=band_hw)

        old()
        same = bool(torch.equal(out, new()))
        n_bytes = n * out_h * out_w * K8_BYTES_PER_PIX[dtype]
        warm = in_turns(old, new)
        cold = [cold_ms(old), cold_ms(new), cold_ms(new), cold_ms(old)]
        rows.append({"kernel": "K8 yuv420_to_rgb", "input": what, "planes": list(planes.shape), "out": list(out.shape),
                     "dtype": str(dtype), "bytes": n_bytes, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                     "identical": same, **warm, "old_cold_ms": [cold[0], cold[3]], "new_cold_ms": [cold[1], cold[2]],
                     "new_trace_ms": trace_ms(new, "yuv420_kernel"), "old_trace_ms": trace_ms(old, "yuv420_kernel"),
                     "write_only_ms": time_ms(out.zero_)})
    old_so = old_dir / "build" / "libcolorconv.so"
    new_so = _build.library_path("colorconv.cu")
    rows.append({"kernel": "K8 compiled",
                 "old": {"ptxas": ptxas_kernels(old_so.with_suffix(".ptxas").read_text().splitlines(), "yuv420"),
                         "sass_global": sass_global_access(old_so, "yuv420")},
                 "new": {"ptxas": ptxas_kernels(_build.ptxas_report("colorconv.cu"), "yuv420"),
                         "sass_global": sass_global_access(new_so, "yuv420")}})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True, help="directory holding an older tiatoolbox_tpu_torch/csrc")
    parser.add_argument("--cases", default="k2,k3,k4,k5,k6", help="comma-separated kernels to time (k2 to k8)")
    args = parser.parse_args()
    cases = set(args.cases.split(","))
    known = {"k2", "k3", "k4", "k5", "k6", "k7", "k8"}
    if not cases <= known:
        parser.error(f"unknown cases {sorted(cases - known)}")
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available.", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    sources = {"k2": ["canvas.cu"], "k3": ["canvas.cu"], "k4": ["region.cu"], "k5": ["hv_energy.cu"],
               "k6": ["canvas.cu", "hv_energy.cu"], "k7": ["stain.cu"], "k8": ["colorconv.cu"]}
    runs = {
        "k2": lambda libs, gen: k2_cases(libs["canvas.cu"], gen),
        "k3": lambda libs, gen: k3_cases(libs["canvas.cu"], gen),
        "k4": lambda libs, gen: k4_cases(libs["region.cu"], gen),
        "k5": lambda libs, gen: k5_cases(libs["hv_energy.cu"], gen),
        "k6": k6_cases,
        "k7": lambda libs, gen: k7_cases(libs["stain.cu"], args.old, gen),
        "k8": lambda libs, gen: k8_cases(libs["colorconv.cu"], args.old),
    }
    libs = {src: build_old(args.old, src) for src in sorted({src for k in cases for src in sources[k]})}
    for kernel in sorted(cases):
        for row in runs[kernel](libs, gen):
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
