"""The port's image processing in host C++ (``csrc/imgproc.cpp``) against cv2 5.0.

Every entry of ``native`` (``resize``, ``warp_affine``, ``remap``, ``blur``,
``morphology``) is held to cv2 on seeded sweeps: sizes 1 to 300 a side,
factors 0.3 to 4, 1, 3 and 4 channels, every type each takes, matrices and
maps that run off the image, box sizes 1 to 31, ellipse, box, cross and
random structuring elements of 3 to 31 pixels, even sizes included.

Tolerance: none, but where cv2 hands a resize to Intel IPP and the port's
reproduction of IPP is not exact (``ROADMAP.md`` section 3). There each
sweep is held to its count of differing values, each one level (or one
float rounding) apart:

- cubic on sources of 4 pixels or more a side (``CUBIC_IPP_DIFFERING``;
  float32 within ``CUBIC_F32_TOL``);
- linear on int16 and float64 sources of 2 pixels or more a side
  (``LINEAR_IPP_DIFFERING``; float64 within ``LINEAR_F64_TOL``), and float32
  enlarged more than 8 times (``LINEAR_F32_BEYOND_8X_DIFFERING``).

Also: 1 and 8 threads give the same bytes; unsupported types raise
``ValueError``; ``imresize`` equals JAX's for every type of its
``_RESIZE_DTYPE_MAP``, more than 4 channels and a 1x1 image; the committed
golden set (``data/imgproc_golden.npz``) is what
``scripts/make_imgproc_golden.py`` writes, and the port replays it.
"""

from __future__ import annotations

import importlib.util
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu.utils import transforms as jax_transforms
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.data import imgproc_golden
from tiatoolbox_tpu_torch.tools.tissuemask import ellipse_kernel
from tiatoolbox_tpu_torch.utils import transforms as port_transforms

INTER = {
    "nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
    "area": cv2.INTER_AREA, "linear_exact": cv2.INTER_LINEAR_EXACT,
}
DTYPES = (np.uint8, np.uint16, np.int16, np.float32, np.float64)
N_CASES = 24  # seeded cases per sweep

# values one level from cv2's over each sweep where cv2 runs IPP's cubic
CUBIC_IPP_DIFFERING = {"uint8": 5, "uint16": 1411, "int16": 1158}
CUBIC_F32_TOL = 4.8e-7  # four float32 roundings at 1.0
# values one level (int16) or one rounding (float64) from cv2's where cv2 runs IPP's linear
LINEAR_IPP_DIFFERING = {"int16": 299, "float64": 31627}
LINEAR_F64_TOL = 1e-13  # on [0, 1] values
LINEAR_F32_BEYOND_8X_DIFFERING = 8910


def seed_of(*parts) -> int:
    """A seed from a case's name (``hash`` of a string changes per process)."""
    return zlib.crc32(repr(parts).encode())


def image_of(rng: np.random.Generator, shape, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.random(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


def random_shape(rng: np.random.Generator, lo: int = 1, hi: int = 300) -> tuple[int, ...]:
    """Mostly under 100 a side, one in eight up to ``hi``; 1, 3 or 4 channels."""
    top = hi if rng.random() < 0.125 else min(hi, 100)
    h, w = (int(v) for v in rng.integers(lo, top + 1, 2))
    cn = int(rng.choice([1, 3, 4]))
    if cn == 1 and rng.random() < 0.5:
        return (h, w)
    return (h, w, cn)


def resize_case(rng: np.random.Generator, lo: int, hi: int, factors=(0.3, 4.0)) -> tuple[tuple, tuple]:
    """A source shape and an output (width, height): a factor in ``factors``
    on each side, or one time in five an integer shrink of sizes that divide."""
    shape = random_shape(rng, lo, hi)
    h, w = shape[:2]
    if rng.random() < 0.2:
        f = int(rng.integers(2, 5))
        dsize = (max(1, w // f), max(1, h // f))
        return (dsize[1] * f, dsize[0] * f, *shape[2:]), dsize
    return shape, (max(1, int(w * rng.uniform(*factors))), max(1, int(h * rng.uniform(*factors))))


def cv2_resize(image: np.ndarray, dsize, mode: str) -> np.ndarray:
    return cv2.resize(image, dsize, interpolation=INTER[mode])


# -- resize, bit for bit --------------------------------------------------------

EXACT_RESIZES = [
    *[(np.dtype(d).name, m) for d in DTYPES for m in ("nearest", "area")],
    ("uint8", "linear"), ("uint16", "linear"), ("float32", "linear"), ("uint8", "linear_exact"),
    ("float64", "cubic"),
]


@pytest.mark.parametrize(("dtype", "mode"), EXACT_RESIZES)
def test_resize_bit_for_bit(dtype: str, mode: str) -> None:
    """The paths cv2 runs in its own code (nearest, area at integer and
    other factors, enlarging area, uint8 linear, linear exact, float64
    cubic) and the IPP linear resizes the port reproduces (uint16, and
    float32 up to 8 times)."""
    rng = np.random.default_rng(seed_of((dtype, mode)))
    for _ in range(N_CASES):
        shape, dsize = resize_case(rng, 1, 300)
        image = image_of(rng, shape, dtype)
        want = cv2_resize(image, dsize, mode)
        got = native.resize(image, dsize, mode)
        assert got.shape == want.shape and got.dtype == want.dtype, (shape, dsize)
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} -> {dsize}")


@pytest.mark.parametrize("dtype", [np.dtype(d).name for d in DTYPES])
@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_resize_of_narrow_sources_bit_for_bit(dtype: str, mode: str) -> None:
    """Sources under 2 (linear) or 4 (cubic) pixels on a side: cv2's own
    resizeGeneric_ (11-bit weights on uint8, the vertical cubic pass in
    float32 vectors and an integer tail)."""
    rng = np.random.default_rng(seed_of((dtype, mode, "narrow")))
    narrow = 2 if mode == "linear" else 4
    for i in range(N_CASES):
        shape = list(random_shape(rng, 1, 120))
        shape[i % 2] = int(rng.integers(1, narrow))
        dsize = (max(1, int(shape[1] * rng.uniform(0.3, 4))), max(1, int(shape[0] * rng.uniform(0.3, 4))))
        image = image_of(rng, tuple(shape), dtype)
        np.testing.assert_array_equal(native.resize(image, dsize, mode), cv2_resize(image, dsize, mode),
                                      err_msg=f"{shape} -> {dsize}")


def _ipp_sweep(dtype: str, mode: str, factors=(0.3, 4.0), lo: int = 4) -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed_of((dtype, mode, factors)))
    out = []
    for _ in range(N_CASES):
        shape, dsize = resize_case(rng, lo, 300, factors)
        image = image_of(rng, shape, dtype)
        got, want = native.resize(image, dsize, mode), cv2_resize(image, dsize, mode)
        assert got.shape == want.shape and got.dtype == want.dtype
        out.append((got, want))
    return out


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16"])
def test_resize_cubic_against_ipp(dtype: str) -> None:
    """cv2's cubic on sources of 4 pixels or more runs Intel IPP: the port
    sums float32 taps in pairs, rows first; a few values differ by one level."""
    differing = 0
    for got, want in _ipp_sweep(dtype, "cubic"):
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1
        differing += int(np.count_nonzero(diff))
    assert differing <= CUBIC_IPP_DIFFERING[dtype]


def test_resize_cubic_float32_against_ipp() -> None:
    for got, want in _ipp_sweep("float32", "cubic"):
        assert np.abs(got.astype(np.float64) - want).max() <= CUBIC_F32_TOL


@pytest.mark.parametrize("dtype", ["int16", "float64"])
def test_resize_linear_against_ipp(dtype: str) -> None:
    differing = 0
    for got, want in _ipp_sweep(dtype, "linear", lo=2):
        diff = np.abs(got.astype(np.float64) - want)
        assert diff.max() <= (1 if dtype == "int16" else LINEAR_F64_TOL)
        differing += int(np.count_nonzero(diff))
    assert differing <= LINEAR_IPP_DIFFERING[dtype]


def test_resize_linear_float32_beyond_8x() -> None:
    differing = 0
    for got, want in _ipp_sweep("float32", "linear", factors=(8.0, 16.0), lo=2):
        assert np.abs(got.astype(np.float64) - want).max() <= 1.2e-7
        differing += int(np.count_nonzero(got != want))
    assert differing <= LINEAR_F32_BEYOND_8X_DIFFERING


# -- warps, blur, morphology ----------------------------------------------------


def random_affine(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A rotation, scale and shift about a point that may lie off the image."""
    centre = (float(rng.uniform(-30, w + 30)), float(rng.uniform(-30, h + 30)))
    matrix = cv2.getRotationMatrix2D(centre, float(rng.uniform(-180, 180)), float(rng.uniform(0.3, 2.5)))
    matrix[:, 2] += rng.uniform(-60, 60, 2)
    if rng.random() < 0.1:
        matrix[:, 2] += 1e5  # wholly off the image
    return matrix


def border_of(rng: np.random.Generator, dtype, cn: int):
    if rng.random() < 0.3:
        return 0
    top = 255 if np.dtype(dtype) == np.uint8 else 1
    return [float(v) for v in rng.uniform(0, top, cn)]


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_warp_affine_bit_for_bit(dtype: str) -> None:
    rng = np.random.default_rng(seed_of(("warp", dtype)))
    for _ in range(N_CASES):
        shape = random_shape(rng, 1, 300)
        image = image_of(rng, shape, dtype)
        matrix = random_affine(rng, *shape[:2])
        dsize = tuple(int(v) for v in rng.integers(1, 200, 2))
        border = border_of(rng, dtype, 1 if len(shape) == 2 else shape[2])
        want = cv2.warpAffine(image, matrix, dsize, flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                              borderValue=tuple(border) if isinstance(border, list) else border)
        np.testing.assert_array_equal(native.warp_affine(image, matrix, dsize, border), want)


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_remap_bit_for_bit(dtype: str) -> None:
    rng = np.random.default_rng(seed_of(("remap", dtype)))
    for i in range(N_CASES):
        shape = random_shape(rng, 1, 300)
        h, w = shape[:2]
        image = image_of(rng, shape, dtype)
        out_h, out_w = (int(v) for v in rng.integers(1, 160, 2))
        map_x = rng.uniform(-12, w + 12, (out_h, out_w)).astype(np.float32)
        map_y = rng.uniform(-12, h + 12, (out_h, out_w)).astype(np.float32)
        if i % 3 == 0:  # on the 1/32 grid and its halves, where the roundings tie
            map_x, map_y = np.round(map_x * 64) / 64, np.round(map_y * 64) / 64
        border = border_of(rng, dtype, 1 if len(shape) == 2 else shape[2])
        want = cv2.remap(image, map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                         borderValue=tuple(border) if isinstance(border, list) else border)
        np.testing.assert_array_equal(native.remap(image, map_x, map_y, border), want)


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_blur_bit_for_bit(dtype: str) -> None:
    """Box sizes 1 to 31, square or not: on uint8 both of OpenCV's roundings
    (16-bit sums up to 257 pixels, 32-bit sums above)."""
    rng = np.random.default_rng(seed_of(("blur", dtype)))
    for i in range(N_CASES):
        image = image_of(rng, random_shape(rng, 1, 300), dtype)
        kw = int(rng.integers(1, 32))
        kh = kw if i % 2 else int(rng.integers(1, 32))
        np.testing.assert_array_equal(native.blur(image, (kw, kh)), cv2.blur(image, (kw, kh)), err_msg=f"{(kw, kh)}")


def element_of(kind: str, rng: np.random.Generator) -> np.ndarray:
    kw = int(rng.integers(3, 32))
    kh = kw if rng.random() < 0.6 else int(rng.integers(3, 32))
    if kind == "ellipse":
        return ellipse_kernel((kw, kh))
    if kind == "rect":
        return np.ones((kh, kw), np.uint8)
    if kind == "cross":
        return cv2.getStructuringElement(cv2.MORPH_CROSS, (kw, kh))
    return (rng.random((kh, kw)) < 0.5).astype(np.uint8)


MORPH_OPS = {"erode": cv2.MORPH_ERODE, "dilate": cv2.MORPH_DILATE, "open": cv2.MORPH_OPEN, "close": cv2.MORPH_CLOSE}


@pytest.mark.parametrize("op", list(MORPH_OPS))
@pytest.mark.parametrize("kind", ["ellipse", "rect", "cross", "random"])
def test_morphology_bit_for_bit(op: str, kind: str) -> None:
    """Masks (0/1, 0/255) and grey images, 1 and 3 channels; the anchor at
    ``ksize // 2``, even sizes included; cv2's border."""
    rng = np.random.default_rng(seed_of(("morph", op, kind)))
    for i in range(N_CASES // 2):
        shape = random_shape(rng, 1, 300)
        if i % 3 == 2:
            image = image_of(rng, shape, np.uint8)
        else:
            image = (rng.random(shape) < rng.uniform(0.2, 0.8)).astype(np.uint8) * (1 if i % 2 else 255)
        kernel = element_of(kind, rng)
        want = cv2.morphologyEx(image, MORPH_OPS[op], kernel)
        np.testing.assert_array_equal(native.morphology(image, kernel, op), want, err_msg=f"{kernel.shape}")


def test_ellipse_kernel_is_cv2s() -> None:
    for kw in range(1, 40):
        for kh in (kw, kw + 3, max(1, kw - 5)):
            np.testing.assert_array_equal(
                ellipse_kernel((kw, kh)), cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (kw, kh))
            )


def test_morphology_into_out_work_and_in_place() -> None:
    rng = np.random.default_rng(9)
    mask = (rng.random((97, 131)) < 0.5).astype(np.uint8)
    kernel = ellipse_kernel((5, 5))
    want = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
    out, work = np.empty_like(mask), np.empty_like(mask)
    assert native.morphology(mask, kernel, "open", out=out, work=work) is out
    np.testing.assert_array_equal(out, want)
    in_place = mask.copy()
    assert native.morphology(in_place, kernel, "open", out=in_place) is in_place
    np.testing.assert_array_equal(in_place, want)
    np.testing.assert_array_equal(native.morphology(mask.astype(bool), kernel, "open"), want)


# -- threads, refusals, the wrappers ---------------------------------------------


def _calls(rng: np.random.Generator):
    big = image_of(rng, (700, 900, 3), np.uint8)
    grey = image_of(rng, (700, 900), np.float32)
    mask = (rng.random((700, 900)) < 0.5).astype(np.uint8)
    matrix = random_affine(rng, 700, 900)
    map_x = rng.uniform(-5, 905, (600, 800)).astype(np.float32)
    map_y = rng.uniform(-5, 705, (600, 800)).astype(np.float32)
    return {
        "area_fractional": lambda t: native.resize(big, (517, 403), "area", n_threads=t),
        "area_2x": lambda t: native.resize(big, (450, 350), "area", n_threads=t),
        "area_enlarge": lambda t: native.resize(big, (1300, 1000), "area", n_threads=t),
        "linear_u8": lambda t: native.resize(big, (517, 1003), "linear", n_threads=t),
        "linear_f32": lambda t: native.resize(grey, (1517, 403), "linear", n_threads=t),
        "cubic_u8": lambda t: native.resize(big, (1200, 333), "cubic", n_threads=t),
        "nearest": lambda t: native.resize(big, (1200, 333), "nearest", n_threads=t),
        "linear_exact": lambda t: native.resize(big, (300, 233), "linear_exact", n_threads=t),
        "warp": lambda t: native.warp_affine(big, matrix, (800, 600), 7, n_threads=t),
        "warp_f32": lambda t: native.warp_affine(grey, matrix, (800, 600), n_threads=t),
        "remap": lambda t: native.remap(big, map_x, map_y, 3, n_threads=t),
        "blur_u8": lambda t: native.blur(big, (21, 19), n_threads=t),
        "blur_f32": lambda t: native.blur(grey, (9, 9), n_threads=t),
        "close": lambda t: native.morphology(mask, ellipse_kernel((31, 31)), "close", n_threads=t),
        "dilate_rect": lambda t: native.morphology(mask, np.ones((20, 20), np.uint8), "dilate", n_threads=t),
    }


@pytest.mark.parametrize("name", list(_calls(np.random.default_rng(0))))
def test_threads_give_the_same_bytes(name: str) -> None:
    call = _calls(np.random.default_rng(11))[name]
    one, eight = call(1), call(8)
    assert one.dtype == eight.dtype and one.tobytes() == eight.tobytes()


def test_refused_types_and_arguments_raise_value_error() -> None:
    refusals = [
        lambda: native.resize(np.zeros((4, 4), np.int32), (2, 2), "area"),
        lambda: native.resize(np.zeros((4, 4), np.float16), (2, 2), "linear"),
        lambda: native.resize(np.zeros((4, 4), np.bool_), (2, 2), "linear"),
        lambda: native.resize(np.zeros((4, 4), np.uint16), (2, 2), "linear_exact"),
        lambda: native.resize(np.zeros((4, 4, 5), np.uint8), (2, 2), "area"),
        lambda: native.resize(np.zeros((4, 4), np.uint8), (2, 2), "lanczos"),
        lambda: native.resize(np.zeros((4, 4), np.uint8), (0, 2), "area"),
        lambda: native.resize(np.zeros((0, 4), np.uint8), (2, 2), "area"),
        lambda: native.warp_affine(np.zeros((4, 4), np.int16), np.eye(3)[:2], (4, 4)),
        lambda: native.remap(np.zeros((4, 4), np.uint16), np.zeros((2, 2)), np.zeros((2, 2))),
        lambda: native.blur(np.zeros((4, 4), np.int32), 3),
        lambda: native.blur(np.zeros((4, 4), np.uint8), (0, 3)),
        lambda: native.morphology(np.zeros((4, 4), np.float32), np.ones((3, 3)), "open"),
        lambda: native.morphology(np.zeros((4, 4), np.uint8), np.ones((3, 3)), "gradient"),
        lambda: native.morphology(np.zeros((4, 4), np.uint8), np.ones((3, 3)), "open", out=np.zeros((4, 5), np.uint8)),
        lambda: port_transforms.shrink_linear_exact(np.zeros((8, 8), np.float32), 2),
    ]
    for refuse in refusals:
        with pytest.raises(ValueError):
            refuse()


IMRESIZE_DTYPES = (np.bool_, np.int8, np.int16, np.int32, np.uint8, np.uint16, np.uint32, np.int64, np.uint64,
                   np.float16, np.float32, np.float64)
IMRESIZE_CASES = (((37, 45, 3), (20, 30)), ((3, 45, 6), (70, 9)), ((29, 31, 1), (12, 40)), ((1, 1), (5, 3)),
                  ((2, 3, 4), (9, 7)))
# working types (``_RESIZE_DTYPE_MAP``) where cv2's resize runs IPP code the
# port does not reproduce bit for bit: linear on int16 and float64; "optimise",
# which shrinking to an output size takes to the cubic, on float32
IPP_INEXACT = {"linear": ("int16", "float64"), "optimise": ("float32",)}


def _imresize_pairs(dtype, interpolation: str):
    rng = np.random.default_rng(3)
    for shape, out_wh in IMRESIZE_CASES:
        image = (rng.random(shape) * 200).astype(dtype)
        want = jax_transforms.imresize(image, output_size=out_wh, interpolation=interpolation)
        got = port_transforms.imresize(image, output_size=out_wh, interpolation=interpolation)
        assert got.shape == want.shape and got.dtype == want.dtype, (shape, out_wh)
        yield got, want, f"{shape} -> {out_wh}"


def _working(dtype) -> str:
    return port_transforms._RESIZE_DTYPE_MAP[np.dtype(dtype)].name  # noqa: SLF001


@pytest.mark.parametrize(
    ("dtype", "interpolation"),
    [(d, i) for i in ("nearest", "area", "linear", "optimise") for d in IMRESIZE_DTYPES
     if _working(d) not in IPP_INEXACT.get(i, ())],
)
def test_imresize_equals_jax(dtype, interpolation: str) -> None:
    """Every type of ``_RESIZE_DTYPE_MAP``, cast as JAX casts; shrinking and
    enlarging; 1, 3 and 6 channels (above 4 a channel at a time); ``[h, w, 1]``
    comes back ``[h, w]``; a 1x1 image is repeated."""
    for got, want, what in _imresize_pairs(dtype, interpolation):
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize(
    ("dtype", "interpolation"),
    [(d, i) for i in ("linear", "optimise") for d in IMRESIZE_DTYPES if _working(d) in IPP_INEXACT[i]],
)
def test_imresize_near_jax_where_cv2_runs_ipp(dtype, interpolation: str) -> None:
    """Where the working type takes IPP code the port does not reproduce bit
    for bit: one level on int16, a few float roundings on floats."""
    for got, want, what in _imresize_pairs(dtype, interpolation):
        diff = np.abs(got.astype(np.float64) - want)
        if got.dtype.kind in "iu":
            tol = 1
        else:
            rel = LINEAR_F64_TOL if got.dtype == np.float64 else 4 * np.finfo(got.dtype).eps
            tol = rel * max(1.0, float(np.abs(want).max()))
        assert diff.max() <= tol, what


# -- the golden set ---------------------------------------------------------------


def _golden_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "make_imgproc_golden.py"
    spec = importlib.util.spec_from_file_location("make_imgproc_golden", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_golden_set_is_fresh_and_the_port_replays_it() -> None:
    fresh = _golden_script().golden()
    committed = np.load(imgproc_golden.GOLDEN_PATH)
    assert sorted(committed.files) == sorted(fresh)
    for name, want in fresh.items():
        assert committed[name].dtype == want.dtype
        np.testing.assert_array_equal(committed[name], want, err_msg=name)
    assert imgproc_golden.GOLDEN_PATH.stat().st_size < 2 * 1024 * 1024
    result = imgproc_golden.check_imgproc_golden()
    assert result == {"arrays": len(fresh), "differing": []}
