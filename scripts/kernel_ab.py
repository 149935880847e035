"""Time the port's K3 and K5 kernels against an earlier tree's, in turns, on one card.

    python3 scripts/kernel_ab.py --old DIR

``DIR`` holds an earlier checkout's ``tiatoolbox_tpu_torch/csrc``, for
example from ``git archive <commit> tiatoolbox_tpu_torch/csrc | tar -x -C DIR``.
The script builds that tree's ``canvas.cu`` and ``hv_energy.cu`` with the
port's nvcc flags into ``DIR/build``, and calls their C entries through
ctypes with buffers made once. The tree's kernels run through the port's
wrappers. Shapes are ``chip_smoke.py``'s: K3 on phase C's canvas (4608 rows
of 6362 pixels, 5 channels, the 4608x6144 crop) and phase D's (3072 x 4100,
4 channels, the 3072x4096 crop), float32 and float16 out; K5 on phase D's
4096x3072 map, from the normalised 4-channel canvas (channels 1:3) and, for
the tree's kernel only, from the raw canvas with its count. The order of
the runs is old, new, new, old; each is the mean of 20 back-to-back calls
timed with CUDA events. The old and new outputs are compared bit for bit.
Last, where the tree's K5 spends its time: its three passes, from a
torch.profiler trace of 10 calls, as the spans between the ends of
consecutive kernels (the Sobel and combine passes may start before the pass
before them ends and wait for it, so their own spans overlap). Prints the
card's name and power limit, then one JSON line per case.
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

import torch  # noqa: E402

from tiatoolbox_tpu_torch import _build  # noqa: E402
from tiatoolbox_tpu_torch.ops import canvas as canvas_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import hv_energy as energy_ops  # noqa: E402

REPS = 20


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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available.", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for row in [*k3_cases(build_old(args.old, "canvas.cu"), gen), *k5_cases(build_old(args.old, "hv_energy.cu"), gen)]:
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
