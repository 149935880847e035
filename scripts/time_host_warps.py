"""Time the port's host image processing against OpenCV's on the same CPU:
the warps of ``chip_smoke.py``'s registration pair and the resizes, blur and
morphology the slide reads and the post-processing run.

    python3 scripts/time_host_warps.py [--reps N] [--out FILE] [--tree DIR]

``--tree`` times the ``tiatoolbox_tpu_torch`` of another checkout (say, an
older commit unpacked with ``git archive``) on the same inputs; the default
is this one.

The pair is the smoke's: its 4096x3072 synthetic slide read at 1.0 mpp
(2048x1536), cut to a section's outline, and that image rotated by 33
degrees and shifted. Three workloads, each run by both sides on the same
inputs, with the outputs checked equal:

- ``prealignment_masks``: prealignment's 36 uint8 mask warps at 2048x1536
  (``warp_affine`` against ``cv2.warpAffine``), the matrices of its search;
- ``affine_read``: one warp of the 2048x1536 RGB image through the true
  transform (what a read through ``TransformedWSIReader`` does per region);
- ``field_read``: one ``remap_linear`` of the RGB image through float32
  maps of that transform plus a smooth displacement (``cv2.remap``);

and, on seeded inputs:

- ``patch_area_2x``: ``imresize(..., "area")`` of a 448^2 RGB patch to
  224^2 (phase B on a 0.25 mpp slide read at 0.5 mpp), on the calling
  thread as the engines' loader threads run it;
- ``patch_area_fractional``: the same patch to 187^2 (a non-integer factor);
- ``thumbnail_area_4x``: a 4096x3072 RGB image to 1024x768 by area;
- ``patch_cubic``: ``imresize(..., "cubic")`` of a 150^2 RGB image to 224^2
  (cv2 runs Intel IPP's cubic here: differing values are counted);
- ``resize_linear``: ``resize_linear`` of the 2048x1536 RGB image to 1536x1152;
- ``box_blur_5``: ``box_blur`` 5x5 of the 2048x1536 RGB image;
- ``linear_exact_4x``: ``shrink_linear_exact`` of the 4096x3072 RGB image by 4;
- ``hovernet_open``: ``hovernet.binary_open`` with the 5x5 ellipse of a
  4096x3072 0/1 mask;
- ``efficientunet_close_open``: EfficientUNet's close then open with the
  31x31 ellipse of the same mask;
- ``hovernetplus_close_open``: HoVer-Net+'s 20x20 box close then open;
- ``tissue_dilate``: ``MorphologicalMasker``'s dilation with a 64x64 ellipse.

Each time is the median of ``--reps`` runs, in ms (a warm-up run first);
cv2 runs with its default threads, the port's calls with their own
choice (one thread below a million elements, else up to 16). Needs cv2,
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


def _tree() -> Path:
    """The checkout to time: ``--tree`` if given (read before argparse runs,
    as the imports below come from it), else this one."""
    if "--tree" in sys.argv:
        return Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
    return Path(__file__).resolve().parents[1]


sys.path.insert(0, str(_tree()))

import chip_smoke  # noqa: E402
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture import efficientunet_tissue_mask_model as effunet  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture import hovernetplus  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.hovernet import binary_open  # noqa: E402
from tiatoolbox_tpu_torch.tools import tissuemask  # noqa: E402
from tiatoolbox_tpu_torch.tools.tissuemask import OtsuTissueMasker, ellipse_kernel  # noqa: E402
from tiatoolbox_tpu_torch.utils.transforms import imresize, shrink_linear_exact  # noqa: E402
from tiatoolbox_tpu_torch.utils.warp import box_blur, remap_linear, resize_linear, warp_affine  # noqa: E402
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader  # noqa: E402


def median_ms(fn, reps: int) -> float:
    fn()
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
    parser.add_argument("--tree", type=Path, default=None, help="checkout whose port is timed")
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

    rng = np.random.default_rng(0)
    patch = rng.integers(0, 256, (448, 448, 3)).astype(np.uint8)
    big = rng.integers(0, 256, (3072, 4096, 3)).astype(np.uint8)
    small = rng.integers(0, 256, (150, 150, 3)).astype(np.uint8)
    # a 0/1 mask of blobs and noise at phase D's canvas size
    mask = (cv2.GaussianBlur(rng.random((3072, 4096)).astype(np.float32), (0, 0), 6) > 0.5).astype(np.uint8)
    mask[rng.random(mask.shape) < 0.01] ^= 1
    ell5, ell31, ell64 = ellipse_kernel((5, 5)), ellipse_kernel((31, 31)), ellipse_kernel((64, 64))
    box20 = np.ones((20, 20), np.uint8)

    def cv_close_open(m, k):
        return cv2.morphologyEx(cv2.morphologyEx(m, cv2.MORPH_CLOSE, k), cv2.MORPH_OPEN, k)

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
        "patch_area_2x": (
            lambda: [imresize(patch, output_size=(224, 224), interpolation="area")],
            lambda: [cv2.resize(patch, (224, 224), interpolation=cv2.INTER_AREA)],
            448 * 448,
        ),
        "patch_area_fractional": (
            lambda: [imresize(patch, output_size=(187, 187), interpolation="area")],
            lambda: [cv2.resize(patch, (187, 187), interpolation=cv2.INTER_AREA)],
            448 * 448,
        ),
        "thumbnail_area_4x": (
            lambda: [imresize(big, output_size=(1024, 768), interpolation="area")],
            lambda: [cv2.resize(big, (1024, 768), interpolation=cv2.INTER_AREA)],
            4096 * 3072,
        ),
        "patch_cubic": (
            lambda: [imresize(small, output_size=(224, 224), interpolation="cubic")],
            lambda: [cv2.resize(small, (224, 224), interpolation=cv2.INTER_CUBIC)],
            224 * 224,
        ),
        "resize_linear": (
            lambda: [resize_linear(moving, (1536, 1152))],
            lambda: [cv2.resize(moving, (1536, 1152), interpolation=cv2.INTER_LINEAR)],
            1536 * 1152,
        ),
        "box_blur_5": (
            lambda: [box_blur(moving, (5, 5))],
            lambda: [cv2.blur(moving, (5, 5))],
            w * h,
        ),
        "linear_exact_4x": (
            lambda: [shrink_linear_exact(big, 4)],
            lambda: [cv2.resize(big, (1024, 768), interpolation=cv2.INTER_LINEAR_EXACT)],
            4096 * 3072,
        ),
        "hovernet_open": (
            lambda: [binary_open(mask, ell5)],
            lambda: [cv2.morphologyEx(mask, cv2.MORPH_OPEN, ell5)],
            mask.size,
        ),
        "efficientunet_close_open": (
            lambda: [effunet.morphology_open(effunet.morphology_close(mask))],
            lambda: [cv_close_open(mask, ell31)],
            mask.size,
        ),
        "hovernetplus_close_open": (
            lambda: [hovernetplus.morphology_open(hovernetplus.morphology_close(mask))],
            lambda: [cv_close_open(mask, box20)],
            mask.size,
        ),
        "tissue_dilate": (
            lambda: [tissuemask._dilate(mask.astype(bool), ell64)],  # noqa: SLF001
            lambda: [cv2.morphologyEx(mask, cv2.MORPH_DILATE, ell64)],
            mask.size,
        ),
    }
    result = {
        "tree": str(args.tree or _tree()),
        "pair": [w, h],
        "cpu": platform.processor() or platform.machine(),
        "cores": os.cpu_count(),
        "cv2": cv2.__version__,
        "cv2_threads": cv2.getNumThreads(),
        "reps": args.reps,
    }
    for name, (port, ref, pixels) in workloads.items():
        pairs = list(zip(port(), ref()))
        differing = sum(int(np.count_nonzero(np.asarray(a).reshape(b.shape) != b)) for a, b in pairs)
        port_ms = median_ms(port, args.reps)
        cv2_ms = median_ms(ref, args.reps)
        result[name] = {
            "bit_exact": differing == 0,
            "differing_values": differing,
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
    # cv2's cubic runs Intel IPP, which the port reproduces to about 1e-5 of values
    return 0 if all(result[k]["bit_exact"] for k in workloads if k != "patch_cubic") else 1


if __name__ == "__main__":
    sys.exit(main())
