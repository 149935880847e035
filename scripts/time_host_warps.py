"""Time the port's host warps (``tiatoolbox_tpu_torch/utils/warp.py``)
against OpenCV's on the same CPU, on ``chip_smoke.py``'s registration pair.

    python3 scripts/time_host_warps.py [--reps N] [--out FILE]

The pair is the smoke's: its 4096x3072 synthetic slide read at 1.0 mpp
(2048x1536), cut to a section's outline, and that image rotated by 33
degrees and shifted. Three workloads, each run by both sides on the same
inputs, with the outputs checked equal:

- ``prealignment_masks``: prealignment's 36 uint8 mask warps at 2048x1536
  (``warp_affine`` against ``cv2.warpAffine``), the matrices of its search;
- ``affine_read``: one warp of the 2048x1536 RGB image through the true
  transform (what a read through ``TransformedWSIReader`` does per region);
- ``field_read``: one ``remap_linear`` of the RGB image through float32
  maps of that transform plus a smooth displacement (``cv2.remap``).

Each time is the median of ``--reps`` runs, in ms; cv2 runs with its
default threads, the port's warps with one thread per core. Needs cv2,
which the port does not import: this script compares, it is not part of
the port. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide  # noqa: E402
from tiatoolbox_tpu_torch.tools.tissuemask import OtsuTissueMasker  # noqa: E402
from tiatoolbox_tpu_torch.utils.warp import remap_linear, warp_affine  # noqa: E402
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader  # noqa: E402


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def search_matrices(fixed_mask: np.ndarray, moving_mask: np.ndarray, step: int) -> list[np.ndarray]:
    """The 2x3 matrices of prealignment's rotation search (rotations about
    the fixed mask's centre after a centre-of-mass shift)."""
    fy, fx = np.argwhere(fixed_mask).mean(axis=0)
    my, mx = np.argwhere(moving_mask).mean(axis=0)
    shift = np.array([[1, 0, fx - mx], [0, 1, fy - my], [0, 0, 1]])
    to_origin = np.array([[1, 0, -fx], [0, 1, -fy], [0, 0, 1]])
    from_origin = np.array([[1, 0, fx], [0, 1, fy], [0, 0, 1]])
    out = []
    for angle in np.arange(0, 360, step):
        c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
        rotation = np.array(((c, -s, 0), (s, c, 0), (0, 0, 1)))
        out.append((from_origin @ rotation @ to_origin @ shift)[:2])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        slide = make_synthetic_slide(
            Path(tmp) / "slide.tiff", size=chip_smoke.SLIDE_WH, mpp=0.5, objective_power=20, compression="deflate"
        )
        region = WSIReader.open(slide).read_bounds((0, 0, *chip_smoke.SLIDE_WH), resolution=chip_smoke.REG_MPP, units="mpp")
    fixed = chip_smoke.tissue_section(region)
    h, w = fixed.shape[:2]
    truth = np.eye(3)
    truth[:2] = chip_smoke.rotation_about((w / 2, h / 2), chip_smoke.REG_ANGLE)
    truth[:2, 2] += chip_smoke.REG_SHIFT
    moving = warp_affine(fixed, truth[:2], (w, h), border_value=255)
    fixed_mask = OtsuTissueMasker().fit_transform(fixed[None])[0].astype(np.uint8)
    moving_mask = OtsuTissueMasker().fit_transform(moving[None])[0].astype(np.uint8)
    matrices = search_matrices(fixed_mask, moving_mask, chip_smoke.REG_ROTATION_STEP)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    bend = np.stack([np.sin(ys / 97.0) * 2.5, np.cos(xs / 131.0) * 2.5], axis=-1)
    field = chip_smoke.composed_field(truth, bend)
    map_x = (xs + field[..., 0]).astype(np.float32)
    map_y = (ys + field[..., 1]).astype(np.float32)

    workloads = {
        "prealignment_masks": (
            lambda: [warp_affine(moving_mask, m, (w, h)) for m in matrices],
            lambda: [cv2.warpAffine(moving_mask, m, (w, h), flags=cv2.INTER_LINEAR) for m in matrices],
            w * h * len(matrices),
        ),
        "affine_read": (
            lambda: [warp_affine(moving, truth[:2], (w, h), border_value=255)],
            lambda: [cv2.warpAffine(moving, truth[:2], (w, h), flags=cv2.INTER_LINEAR, borderValue=(255, 255, 255))],
            w * h,
        ),
        "field_read": (
            lambda: [remap_linear(moving, map_x, map_y, border_value=255)],
            lambda: [cv2.remap(moving, map_x, map_y, cv2.INTER_LINEAR, borderValue=(255, 255, 255))],
            w * h,
        ),
    }
    result = {
        "pair": [w, h],
        "cpu": platform.processor() or platform.machine(),
        "cores": os.cpu_count(),
        "cv2": cv2.__version__,
        "cv2_threads": cv2.getNumThreads(),
        "reps": args.reps,
    }
    for name, (port, ref, pixels) in workloads.items():
        equal = all(np.array_equal(a, b) for a, b in zip(port(), ref()))
        port_ms = median_ms(port, args.reps)
        cv2_ms = median_ms(ref, args.reps)
        result[name] = {
            "bit_exact": equal,
            "port_ms": port_ms,
            "cv2_ms": cv2_ms,
            "port_mpix_per_s": pixels / 1e3 / port_ms,
            "cv2_mpix_per_s": pixels / 1e3 / cv2_ms,
            "ratio": port_ms / cv2_ms,
        }
    text = json.dumps(result)
    print(text)
    if args.out is not None:
        args.out.write_text(text + "\n")
    return 0 if all(result[k]["bit_exact"] for k in workloads) else 1


if __name__ == "__main__":
    sys.exit(main())
