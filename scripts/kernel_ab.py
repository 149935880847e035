"""Time the port's K2-K5 kernels against an earlier tree's, in turns, on one card.

    python3 scripts/kernel_ab.py --old DIR [--cases k2,k3,k4,k5]

``DIR`` holds an earlier checkout's ``tiatoolbox_tpu_torch/csrc``, for
example from ``git archive <commit> tiatoolbox_tpu_torch/csrc | tar -x -C DIR``.
The script builds that tree's ``canvas.cu``, ``region.cu`` and
``hv_energy.cu`` with the port's nvcc flags into ``DIR/build``, and calls
their C entries through ctypes with buffers made once. The tree's kernels
run through the port's wrappers. Shapes are ``chip_smoke.py``'s:

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
  its count.

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
import json
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
from tiatoolbox_tpu_torch.ops import hv_energy as energy_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import region as region_ops  # noqa: E402

REPS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# (canvas h, width, channels, patch side, stride, batch) of the first region-feed batch
K2_SHAPES = {"C": (4608, 6362, 5, 512, 450, 16), "D": (3072, 4100, 4, 164, 164, 32)}
# (band h, band w, patch side, stride, batch)
K4_SHAPES = {"C": (1474, 6874, 1024, 450, 16), "D": (748, 4192, 256, 164, 32)}


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


def energy_passes(fn) -> dict:
    """Median spans (ms) of K5's min/max, Sobel and combine passes over 10 calls of ``fn``."""
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
        if "hv_minmax" in e["name"] and i + 2 < len(kernels):
            ends = [k["ts"] + k["dur"] for k in kernels[i : i + 3]]
            spans["minmax"].append(ends[0] - e["ts"])
            spans["sobel"].append(ends[1] - ends[0])
            spans["combine"].append(ends[2] - ends[1])
    return {name: statistics.median(v) / 1e3 for name, v in spans.items() if v}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, required=True, help="directory holding an older tiatoolbox_tpu_torch/csrc")
    parser.add_argument("--cases", default="k2,k3,k4,k5", help="comma-separated kernels to time (k2, k3, k4, k5)")
    args = parser.parse_args()
    cases = set(args.cases.split(","))
    if not cases <= {"k2", "k3", "k4", "k5"}:
        parser.error(f"unknown cases {sorted(cases - {'k2', 'k3', 'k4', 'k5'})}")
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available.", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    sources = {"k2": "canvas.cu", "k3": "canvas.cu", "k4": "region.cu", "k5": "hv_energy.cu"}
    runs = {"k2": k2_cases, "k3": k3_cases, "k4": k4_cases, "k5": k5_cases}
    libs = {src: build_old(args.old, src) for src in sorted({sources[k] for k in cases})}
    for kernel in sorted(cases):
        for row in runs[kernel](libs[sources[kernel]], gen):
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
