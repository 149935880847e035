"""Write the golden set that holds GrandQC's JPEG preproc on the card to OpenCV.

    python scripts/make_grandqc_golden.py [--out tiatoolbox_tpu_torch/data/grandqc_jpeg_golden.npz]

Needs OpenCV (``cv2``). GrandQC's preproc (upstream ``grandqc.py``, JAX
``tiatoolbox_tpu/models/architecture/grandqc.py:140-148``) hands the RGB
patch to ``cv2.imencode(".jpg", patch, [IMWRITE_JPEG_QUALITY, 80])``, which
takes it for BGR, and decodes it with ``cv2.imdecode(stream, 1)``. The set
holds a few seeded patches (synthetic H&E and noise, odd sizes) with the
stream's bytes and the decoded pixels; ``chip_smoke.py`` holds the card
machine's build of ``grandqc.jpeg_roundtrip`` to it, and
``tests/test_torch_tissue_models.py`` checks that the committed file is what
this script writes.
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch  # noqa: E402

DEFAULT_OUT = ROOT / "tiatoolbox_tpu_torch" / "data" / "grandqc_jpeg_golden.npz"
QUALITY = 80
# (kind, height, width, seed)
CASES = (("he", 64, 64, 1), ("he", 37, 53, 2), ("noise", 33, 47, 3), ("he", 96, 80, 4))


def patch(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    if kind == "he":
        return synthetic_he_patch((h, w), seed=seed)
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def build() -> dict[str, np.ndarray]:
    import cv2

    out: dict[str, np.ndarray] = {"quality": np.array(QUALITY), "cv2_version": np.array(cv2.__version__)}
    for i, case in enumerate(CASES):
        image = patch(*case)
        stream = cv2.imencode(".jpg", image, [int(cv2.IMWRITE_JPEG_QUALITY), QUALITY])[1]
        out[f"input_{i}"] = image
        out[f"stream_{i}"] = np.asarray(stream, np.uint8).ravel()
        out[f"output_{i}"] = np.asarray(cv2.imdecode(stream, 1))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    buf = io.BytesIO()
    np.savez_compressed(buf, **build())
    args.out.write_bytes(buf.getvalue())
    print(f"{args.out}: {args.out.stat().st_size} bytes")


if __name__ == "__main__":
    main()
