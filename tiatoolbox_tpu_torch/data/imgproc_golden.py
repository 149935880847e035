"""Golden set for the port's image processing, checked where cv2 is absent.

``scripts/make_imgproc_golden.py`` runs ``imgproc_cases()`` through cv2
(``cv2.resize``, ``cv2.warpAffine``, ``cv2.remap``, ``cv2.blur``,
``cv2.morphologyEx``) and writes the outputs to ``imgproc_golden.npz``
beside this file. ``check_imgproc_golden`` runs the same seeded cases
through the port's host C++ (``native.resize``, ``warp_affine``, ``remap``,
``blur``, ``morphology``) and compares bit for bit, so ``chip_smoke.py``
holds the card machine's build (another compiler and CPU) to cv2.

The cases cover every path the port gives bit for bit: each resize
interpolation on every type it takes (the cubic on sources under 4 pixels
a side and on float64, where cv2 runs its own code, and float32 linear up
to 4x, where it runs Intel IPP's), warps and remaps that run off the image,
blurs of both uint8 roundings, and erosion, dilation, opening and closing
with ellipses, boxes and random elements, even sizes included.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

GOLDEN_PATH = Path(__file__).resolve().parent / "imgproc_golden.npz"
DTYPES = ("uint8", "uint16", "int16", "float32", "float64")


def _image(rng: np.random.Generator, shape, dtype: str) -> np.ndarray:
    if dtype in ("float32", "float64"):
        return rng.random(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


def _shape(rng: np.random.Generator, lo: int, hi: int) -> tuple[int, ...]:
    h, w = (int(v) for v in rng.integers(lo, hi, 2))
    cn = int(rng.choice([1, 3, 4]))
    return (h, w) if cn == 1 else (h, w, cn)


def _resize_cases(rng: np.random.Generator) -> list[dict]:
    cases = []
    for dtype in DTYPES:
        modes = ["nearest", "area", "area", "area", "linear"]
        if dtype in ("uint8", "float32", "float64"):
            modes.append("cubic")
        if dtype == "uint8":
            modes += ["linear_exact", "linear"]
        for mode in modes:
            shape = _shape(rng, 1, 4) if mode == "cubic" and dtype != "float64" else _shape(rng, 2, 48)
            if mode == "linear" and dtype != "uint8" and dtype != "float32" and dtype != "uint16":
                shape = (1, *shape[1:])  # cv2's own linear: a source one pixel high
            h, w = shape[:2]
            if mode == "area" and len([c for c in cases if c["mode"] == "area" and c["dtype"] == dtype]) == 0:
                f = int(rng.integers(2, 5))  # an integer factor, cv2's fast path
                dsize = (max(1, w // f), max(1, h // f))
                shape = (dsize[1] * f, dsize[0] * f, *shape[2:])
            else:
                lo, hi = (0.3, 4.0) if mode != "linear" or dtype == "uint8" else (0.3, 3.9)
                dsize = (max(1, int(w * rng.uniform(lo, hi))), max(1, int(h * rng.uniform(lo, hi))))
            cases.append({"kind": "resize", "mode": mode, "dtype": dtype, "shape": shape, "dsize": dsize})
    return cases


def imgproc_cases() -> list[dict]:
    """Seeded cases: ``kind`` (resize, warp, remap, blur, morph), the input's
    ``dtype`` and ``shape`` and each kind's arguments; ``case_input`` makes the
    input and ``run_port`` runs a case through the port."""
    rng = np.random.default_rng(4000)
    cases = _resize_cases(rng)
    for dtype in ("uint8", "float32", "float64"):
        for _ in range(2):
            shape = _shape(rng, 8, 64)
            h, w = shape[:2]
            angle, scale = np.radians(rng.uniform(-180, 180)), rng.uniform(0.4, 2.0)
            c, s = np.cos(angle) * scale, np.sin(angle) * scale
            centre = rng.uniform(-8, max(h, w) + 8, 2)
            matrix = np.array([[c, -s, 0.0], [s, c, 0.0]])
            matrix[:, 2] = centre - matrix[:, :2] @ centre + rng.uniform(-20, 20, 2)
            dsize = tuple(int(v) for v in rng.integers(8, 72, 2))
            border = [float(v) for v in rng.uniform(0, 255 if dtype == "uint8" else 1, 4)][: 1 if len(shape) == 2 else shape[2]]
            cases.append({"kind": "warp", "dtype": dtype, "shape": shape, "matrix": matrix, "dsize": dsize,
                          "border": border})
            map_seed = int(rng.integers(1 << 30))
            cases.append({"kind": "remap", "dtype": dtype, "shape": shape, "dsize": dsize, "border": border,
                          "map_seed": map_seed})
        for ksize in ((3, 3), (5, 5), (7, 4), (17, 17), (31, 9)):
            cases.append({"kind": "blur", "dtype": dtype, "shape": _shape(rng, 4, 64), "ksize": ksize})
    for element in ("ellipse5", "ellipse31", "ellipse20", "rect20", "rect7x4", "random"):
        for op in ("erode", "dilate", "open", "close"):
            cases.append({"kind": "morph", "dtype": "uint8", "shape": tuple(int(v) for v in rng.integers(8, 96, 2)),
                          "element": element, "op": op, "element_seed": int(rng.integers(1 << 30))})
    for i, case in enumerate(cases):
        case["seed"] = 5000 + i
    return cases


def element(case: dict) -> np.ndarray:
    """The structuring element of a ``morph`` case."""
    from tiatoolbox_tpu_torch.tools.tissuemask import ellipse_kernel

    name = case["element"]
    if name.startswith("ellipse"):
        k = int(name[len("ellipse"):])
        return ellipse_kernel((k, k))
    if name == "rect20":
        return np.ones((20, 20), np.uint8)
    if name == "rect7x4":
        return np.ones((4, 7), np.uint8)
    return (np.random.default_rng(case["element_seed"]).random((6, 9)) < 0.5).astype(np.uint8)


def case_input(case: dict) -> np.ndarray:
    """The case's seeded input image (a 0/1 mask for ``morph``)."""
    rng = np.random.default_rng(case["seed"])
    if case["kind"] == "morph":
        return (rng.random(case["shape"]) < 0.55).astype(np.uint8)
    return _image(rng, case["shape"], case["dtype"])


def case_maps(case: dict) -> tuple[np.ndarray, np.ndarray]:
    """A ``remap`` case's float32 maps, running past every edge."""
    rng = np.random.default_rng(case["map_seed"])
    h, w = case["shape"][:2]
    out_w, out_h = case["dsize"]
    map_x = rng.uniform(-6, w + 6, (out_h, out_w)).astype(np.float32)
    map_y = rng.uniform(-6, h + 6, (out_h, out_w)).astype(np.float32)
    return map_x, map_y


def run_port(case: dict) -> np.ndarray:
    """A case through the port's host C++."""
    from tiatoolbox_tpu_torch import native

    image = case_input(case)
    kind = case["kind"]
    if kind == "resize":
        return native.resize(image, case["dsize"], case["mode"])
    if kind == "warp":
        return native.warp_affine(image, case["matrix"], case["dsize"], case["border"])
    if kind == "remap":
        return native.remap(image, *case_maps(case), case["border"])
    if kind == "blur":
        return native.blur(image, case["ksize"])
    return native.morphology(image, element(case), case["op"])


def check_imgproc_golden(path: Path = GOLDEN_PATH) -> dict:
    """Replay every case through the port and compare with cv2's outputs.

    Returns:
        ``{"arrays": n, "differing": [names]}``: the number of arrays
        compared and the cases whose output is not cv2's bit for bit (or
        missing from the file).
    """
    golden = np.load(path)
    differing = []
    cases = imgproc_cases()
    for i, case in enumerate(cases):
        name = f"case_{i}"
        got = run_port(case)
        if name not in golden or got.dtype != golden[name].dtype or not np.array_equal(got, golden[name]):
            differing.append(name)
    return {"arrays": len(cases), "differing": differing}
