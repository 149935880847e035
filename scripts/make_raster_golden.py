"""Write the golden set the port's rendering and slide graph are checked against without cv2 or JAX.

    python scripts/make_raster_golden.py [--out tiatoolbox_tpu_torch/data/raster_golden.npz]

Needs OpenCV (``cv2``) and the JAX package's ``tools/graph.py`` (numpy and
scipy only). The seeded cases live in ``tiatoolbox_tpu_torch/data/render_golden.py``:

- ``draw_<i>``: each scene of ``raster_cases()`` drawn with ``cv2.fillPoly``,
  ``cv2.polylines``, ``cv2.line`` and ``cv2.circle`` at ``LINE_8``;
- ``blur_<k>``: ``cv2.blur`` of ``blur_cases()``'s image for box size ``k``;
- ``colormap_<id>``: ``cv2.applyColorMap`` of ``colormap_cases()``'s grey
  image, converted to RGB, for every OpenCV colormap id (``n_colormaps``);
- ``graph_x``, ``graph_edge_index``, ``graph_coordinates`` and ``graph_pca``:
  the JAX ``SlideGraphConstructor.build`` of ``graph_case()`` and its
  ``_pca_reducer`` colours.

``tests/test_torch_raster.py`` checks that the committed file is what this
script writes; ``chip_smoke.py`` replays it through the port on the card machine.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tiatoolbox_tpu_torch.data import render_golden  # noqa: E402

DEFAULT_OUT = render_golden.GOLDEN_PATH


def draw_cv2(case: dict) -> np.ndarray:
    import cv2

    img = case["canvas"].copy()
    for kind, args in case["ops"]:
        if kind == "fill":
            cv2.fillPoly(img, [args[0].reshape(-1, 1, 2)], args[1])
        elif kind == "hole":
            cv2.fillPoly(img, [args[0].reshape(-1, 1, 2)], (0, 0, 0, 0))
        elif kind == "poly":
            cv2.polylines(img, [args[0].reshape(-1, 1, 2)], args[1], args[2], args[3])
        elif kind == "line":
            cv2.line(img, *args)
        else:
            cv2.circle(img, args[0], args[1], args[2], -1)
    return img


def golden() -> dict[str, np.ndarray]:
    import cv2

    from tiatoolbox_tpu.tools.graph import SlideGraphConstructor

    out = {f"draw_{i}": draw_cv2(case) for i, case in enumerate(render_golden.raster_cases())}
    for img, k in render_golden.blur_cases():
        out[f"blur_{k}"] = cv2.blur(img, (k, k))
    grey = render_golden.colormap_cases()
    ids = sorted({int(getattr(cv2, n)) for n in dir(cv2) if n.startswith("COLORMAP_")})
    for cmap_id in ids:
        out[f"colormap_{cmap_id}"] = cv2.cvtColor(cv2.applyColorMap(grey, cmap_id), cv2.COLOR_BGR2RGB)
    out["n_colormaps"] = np.array(len(ids))
    points, features = render_golden.graph_case()
    graph = SlideGraphConstructor.build(points, features)
    for key in ("x", "edge_index", "coordinates"):
        out[f"graph_{key}"] = np.asarray(graph[key])
    out["graph_pca"] = SlideGraphConstructor._pca_reducer(graph)  # noqa: SLF001
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    np.savez_compressed(args.out, **golden())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
