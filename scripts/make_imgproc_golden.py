"""Write the golden set the port's image processing is checked against without cv2.

    python scripts/make_imgproc_golden.py [--out tiatoolbox_tpu_torch/data/imgproc_golden.npz]

Needs OpenCV (``cv2``). The seeded cases live in
``tiatoolbox_tpu_torch/data/imgproc_golden.py``; ``case_<i>`` is cv2's
output for ``imgproc_cases()[i]``: ``cv2.resize`` with the case's
interpolation, ``cv2.warpAffine`` and ``cv2.remap`` (``INTER_LINEAR``,
``BORDER_CONSTANT``), ``cv2.blur`` or ``cv2.morphologyEx``.

``tests/test_torch_imgproc.py`` checks that the committed file is what this
script writes and that the port replays it; ``chip_smoke.py`` replays it
through the port on the card machine.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tiatoolbox_tpu_torch.data import imgproc_golden  # noqa: E402

DEFAULT_OUT = imgproc_golden.GOLDEN_PATH


def run_cv2(case: dict) -> np.ndarray:
    import cv2

    image = imgproc_golden.case_input(case)
    kind = case["kind"]
    if kind == "resize":
        inter = {
            "nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
            "area": cv2.INTER_AREA, "linear_exact": cv2.INTER_LINEAR_EXACT,
        }[case["mode"]]
        return cv2.resize(image, case["dsize"], interpolation=inter)
    if kind == "warp":
        return cv2.warpAffine(image, case["matrix"], case["dsize"], flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=tuple(case["border"]))
    if kind == "remap":
        return cv2.remap(image, *imgproc_golden.case_maps(case), cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=tuple(case["border"]))
    if kind == "blur":
        return cv2.blur(image, case["ksize"])
    ops = {"erode": cv2.MORPH_ERODE, "dilate": cv2.MORPH_DILATE, "open": cv2.MORPH_OPEN, "close": cv2.MORPH_CLOSE}
    return cv2.morphologyEx(image, ops[case["op"]], imgproc_golden.element(case))


def golden() -> dict[str, np.ndarray]:
    return {f"case_{i}": run_cv2(case) for i, case in enumerate(imgproc_golden.imgproc_cases())}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    arrays = golden()
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {len(arrays)} arrays to {args.out} ({args.out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
