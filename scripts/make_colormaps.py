"""Write the colour tables the port's output writers use without OpenCV or matplotlib.

    python scripts/make_colormaps.py [--out tiatoolbox_tpu_torch/data/colormaps.npz]

Needs OpenCV (``cv2``) and matplotlib. For every OpenCV colormap id the
file holds ``cv2_<id>``, the 256 RGB colours ``cv2.applyColorMap`` gives
the grey levels 0-255 (uint8 ``[256, 3]``; ``applyColorMap`` of a uint8
grey image is this lookup, converted from BGR), which
``write_probability_heatmap_as_ome_tiff`` applies; and ``tab20``,
matplotlib's 20 RGBA colours (float64 ``[20, 4]``), from which
``patch_predictions_as_qupath_json`` picks class colours as
``colormaps["tab20"].resampled(n)`` does. ``tests/test_torch_store_conversion.py``
checks that the committed file is what this script writes.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tiatoolbox_tpu_torch" / "data" / "colormaps.npz"


def cv2_colormap_ids() -> list[int]:
    """Every ``cv2.COLORMAP_*`` id."""
    import cv2

    return sorted({int(getattr(cv2, n)) for n in dir(cv2) if n.startswith("COLORMAP_")})


def tables() -> dict[str, np.ndarray]:
    import cv2
    from matplotlib import colormaps

    grey = np.arange(256, dtype=np.uint8)[None, :]
    out = {
        f"cv2_{i}": np.ascontiguousarray(cv2.applyColorMap(grey, i)[0, :, ::-1])
        for i in cv2_colormap_ids()
    }
    out["tab20"] = np.asarray(colormaps["tab20"].colors, dtype=np.float64)
    out["tab20"] = np.concatenate([out["tab20"], np.ones((20, 1))], axis=1)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    np.savez_compressed(args.out, **tables())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
