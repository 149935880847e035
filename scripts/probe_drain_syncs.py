"""Which host calls of the drain wait for a busy card (needs a CUDA card).

The drain (``tiatoolbox_tpu_torch/parallel/pipeline.py``) overlaps host
post-processing with the device-to-host copies only if nothing it calls at
dispatch waits for the work already queued on the card. Each step below runs
in a fresh process's first use, after ``torch.cuda._sleep`` has queued about
half a second of work on the current stream; a step whose host seconds come
close to the sleep's waited for it. Steps, in order: a side stream from the
pool, the first pinned allocation, a pinned allocation of a new size, a
blocking event, a non-blocking copy to pinned memory, the first launch of
kernels K3, K6 and K5 (``ops/canvas.py::pack_fg_tp``, ``ops/hv_energy.py``), and
the copy stream of the drain with a fetch through it. With ``--prepared`` the
process first calls ``pipeline.prepare_device`` on an idle card, as the
multitask engine does before its loop, and every step should then take a
small share of the sleep.

Run: ``python3 scripts/probe_drain_syncs.py [--prepared]`` (builds the kernels
first; prints one JSON line with each step's seconds, the sleep's, the
seconds of ``prepare_device`` if it ran, and the card).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from tiatoolbox_tpu_torch import _build  # noqa: E402
from tiatoolbox_tpu_torch.ops import canvas as canvas_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import hv_energy as energy_ops  # noqa: E402
from tiatoolbox_tpu_torch.parallel import pipeline  # noqa: E402

SLEEP_CYCLES = 1_000_000_000


def busy_seconds(step) -> float:
    """Host seconds of ``step()`` while the card works through a long sleep."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    step()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_drain_syncs: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda")
    prepare_seconds = None
    if "--prepared" in sys.argv[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.prepare_device(dev)
        prepare_seconds = time.perf_counter() - t0
    h, w = 3072, 4096
    canvas = torch.rand((h, w, 4), device=dev)
    count = torch.ones((h, w, 1), device=dev)
    kept: list = []
    steps = {
        "stream_from_pool": lambda: kept.append(torch.cuda.Stream(dev)),
        "first_pinned_64MiB": lambda: kept.append(torch.empty(1 << 26, dtype=torch.uint8, pin_memory=True)),
        "pinned_new_size_16MiB": lambda: kept.append(torch.empty(1 << 24, dtype=torch.uint8, pin_memory=True)),
        "blocking_event": lambda: kept.append(torch.cuda.Event(blocking=True)),
        "copy_to_pinned_non_blocking": lambda: kept[2].copy_(
            canvas.view(-1)[: 1 << 22].view(torch.uint8), non_blocking=True
        ),
        "first_k3_launch": lambda: kept.append(canvas_ops.normalize_rows(canvas, count, 0, h, w)),
        "first_k6_launch": lambda: kept.append(canvas_ops.pack_fg_tp(canvas, count, h, w, 3)),
        "first_k5_launch_with_minmax": lambda: kept.append(
            energy_ops.hv_energy(canvas[..., 1:3], count=count, minmax=kept[-1][1])
        ),
        "first_drain_copy_stream": lambda: kept.append(pipeline.copy_stream(dev)),
        "fetch_chunked_async_dispatch": lambda: kept.append(pipeline.fetch_chunked_async(canvas[..., :1])),
        "k6_second_launch": lambda: kept.append(canvas_ops.pack_fg_tp(canvas, count, h, w, 3)),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    torch.cuda.synchronize()
    sleep = time.perf_counter() - t0
    out = {name: busy_seconds(step) for name, step in steps.items()}
    kept[-2][1].wait_all()
    print(json.dumps({
        "probe": "drain_syncs", "prepared": prepare_seconds is not None, "prepare_seconds": prepare_seconds,
        "sleep_seconds": sleep, "step_seconds": out, "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
