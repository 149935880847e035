"""HoVer-Net instance post-processing: the port against cv2 and the JAX package on the CPU.

The port has no cv2: its host pieces are numpy, scipy and its own C++
(``csrc/watershed.cpp``). Each is held here to the exact result of what it
replaces, on seeded maps:

- the contour follower against ``cv2.findContours(RETR_TREE,
  CHAIN_APPROX_SIMPLE)[0]`` (hypothesis over 8-connected shapes with holes,
  one-pixel lines, diagonal joins and pixels on the crop's edge; every
  watershed instance is one 4-connected region, so one shape per map);
- the marker watershed against ``tiatoolbox_tpu.native.watershed``;
- min-max normalisation, the ksize-21 Sobel, the 3x3 Gaussian blur and the
  5x5 elliptical opening against cv2, and the hole filling against JAX's
  flood fill;
- ``_proc_np_hv``, ``_proc_np_energy``, ``get_instance_info`` and
  ``postproc`` against JAX's ``HoVerNet`` on the two-nucleus maps of
  ``tests/models/test_hovernet_postproc_ext.py`` and on maps with many
  nuclei.

All comparisons are exact (equal arrays, equal dicts).
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import ndimage

from tiatoolbox_tpu import native as jax_native
from tiatoolbox_tpu.models.architecture import hovernet as jax_hovernet
from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.models.architecture import hovernet
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
from tiatoolbox_tpu_torch.tools.tissuemask import ellipse_kernel


def _cv2_first_contour(mask: np.ndarray) -> np.ndarray:
    return cv2.findContours(mask.astype(np.uint8), cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)[0][0].reshape(-1, 2)


def _port_contour(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    labels = mask.astype(np.int32)
    return native.outer_contours(labels, [1], [[ys[0], xs[0]]], [int(mask.sum())])[0]


def _largest_8_connected(mask: np.ndarray) -> np.ndarray:
    lab, n = ndimage.label(mask, structure=np.ones((3, 3)))
    if n == 0:
        return mask.astype(np.uint8)
    sizes = np.bincount(lab.ravel())
    sizes[0] = 0
    return (lab == sizes.argmax()).astype(np.uint8)


@st.composite
def shapes(draw) -> np.ndarray:
    """One 8-connected shape: random pixels, plus lines, rings and diagonals."""
    h = draw(st.integers(1, 14))
    w = draw(st.integers(1, 14))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < draw(st.floats(0.15, 0.95))
    kind = draw(st.sampled_from(["pixels", "ring", "line", "diagonal"]))
    if kind == "ring" and h >= 3 and w >= 3:
        mask[:] = False
        mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    elif kind == "line":
        mask[rng.integers(0, h), :] = True
    elif kind == "diagonal":
        for i in range(min(h, w)):
            mask[i, i] = True
    return _largest_8_connected(mask)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(shapes())
def test_contour_follower_equals_cv2(mask: np.ndarray) -> None:
    if not mask.any():
        return
    np.testing.assert_array_equal(_port_contour(mask), _cv2_first_contour(mask))


@pytest.mark.parametrize(
    "name",
    ["square with a hole", "single pixel", "two pixels", "diagonal join", "edge touching", "hole and line"],
)
def test_contour_follower_named_cases(name: str) -> None:
    mask = np.zeros((9, 9), np.uint8)
    if name == "square with a hole":
        mask[1:8, 1:8] = 1
        mask[3:6, 3:6] = 0
    elif name == "single pixel":
        mask[4, 4] = 1
    elif name == "two pixels":
        mask[4, 4:6] = 1
    elif name == "diagonal join":
        mask[1:4, 1:4] = 1
        mask[4:7, 4:7] = 1
    elif name == "edge touching":
        mask[0:9, 0:3] = 1
        mask[8, :] = 1
    else:
        mask[2:7, 2:7] = 1
        mask[4, 4] = 0
        mask[4, 0:3] = 1
    np.testing.assert_array_equal(_port_contour(mask), _cv2_first_contour(mask))
    if name == "square with a hole":
        assert _port_contour(mask).tolist() == [[1, 1], [1, 7], [7, 7], [7, 1]]


def test_contours_of_many_instances_in_one_call() -> None:
    rng = np.random.default_rng(5)
    labels = ndimage.label(rng.random((60, 70)) < 0.5)[0].astype(np.int32)
    ids = np.arange(1, labels.max() + 1)
    flat = labels.ravel()
    first = np.array([np.flatnonzero(flat == i)[0] for i in ids])
    starts = np.stack([first // 70, first % 70], axis=-1)
    areas = np.bincount(flat)[ids]
    got = native.outer_contours(labels, ids, starts, areas)
    for i, contour in zip(ids, got):
        slc = ndimage.find_objects(labels == i)[0]
        crop = (labels[slc] == i).astype(np.uint8)
        want = _cv2_first_contour(crop) + [slc[1].start, slc[0].start]
        np.testing.assert_array_equal(contour, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watershed_equals_jax_native(seed: int) -> None:
    rng = np.random.default_rng(seed)
    h, w = 57, 83
    image = ndimage.gaussian_filter(rng.random((h, w)), 2)
    # ties: quantised values exercise the first-in-first-out order
    image = np.round(image * 20) / 20
    markers = np.zeros((h, w), np.int32)
    pts = rng.integers(0, [h, w], (12, 2))
    markers[pts[:, 0], pts[:, 1]] = np.arange(1, 13)
    mask = rng.random((h, w)) < 0.85
    want = jax_native.watershed(image, markers, mask)
    if want is None:  # the JAX native library did not build here: its Python flood
        want = jax_hovernet._watershed(image, markers, mask)
    np.testing.assert_array_equal(native.watershed(image, markers, mask), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e5])
def test_normalize_minmax_equals_cv2(dtype, scale: float) -> None:
    x = (np.random.default_rng(7).standard_normal((61, 47)) * scale).astype(dtype)
    want = cv2.normalize(x, None, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_32F)
    np.testing.assert_array_equal(hovernet.normalize_minmax(x), want)
    const = np.full((5, 4), 3.0, dtype)
    np.testing.assert_array_equal(
        hovernet.normalize_minmax(const),
        cv2.normalize(const, None, alpha=0, beta=1, norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_32F),
    )


@pytest.mark.parametrize("shape", [(67, 53), (30, 13), (5, 40), (1, 9), (120, 96)])
@pytest.mark.parametrize("ksize", [21, 11, 3])
def test_sobel_equals_cv2(shape, ksize: int) -> None:
    x = np.random.default_rng(ksize).random(shape).astype(np.float32)
    for dx, dy in ((1, 0), (0, 1)):
        want = cv2.Sobel(x, cv2.CV_64F, dx, dy, ksize=ksize)
        np.testing.assert_array_equal(hovernet.sobel(x, dx, dy, ksize), want)


@pytest.mark.parametrize("shape", [(67, 53), (3, 4), (1, 5), (200, 150)])
def test_gaussian_blur_equals_cv2(shape) -> None:
    x = np.random.default_rng(2).random(shape)
    np.testing.assert_array_equal(hovernet.gaussian_blur_3x3(x), cv2.GaussianBlur(x, (3, 3), 0))


@pytest.mark.parametrize("density", [0.3, 0.7, 0.95])
def test_open_and_fill_equal_cv2_and_jax(density: float) -> None:
    rng = np.random.default_rng(int(density * 100))
    mask = ndimage.binary_opening(rng.random((90, 70)) < density).astype(np.uint8)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
    np.testing.assert_array_equal(ellipse_kernel((5, 5)), kernel)
    np.testing.assert_array_equal(
        hovernet.binary_open(mask, ellipse_kernel((5, 5))), cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
    )
    marker = mask.astype(np.int32)
    want = jax_hovernet._fill_holes(marker, np.empty(marker.shape, np.uint8))
    np.testing.assert_array_equal(hovernet.fill_holes(marker), want)
    np.testing.assert_array_equal(hovernet.fill_holes(marker), ndimage.binary_fill_holes(mask))


def two_blob_maps(sep: int = 12):
    """NP/HV maps with two circular nuclei ``sep`` px apart (``tests/models/test_hovernet_postproc_ext.py``)."""
    h = w = 80
    np_map = np.zeros((h, w, 1), np.float32)
    hv_map = np.zeros((h, w, 2), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for cy, cx in [(30, 30), (30, 30 + sep)]:
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= 8**2
        np_map[inside, 0] = 0.95
        hv_map[inside, 0] = np.clip((xx[inside] - cx) / 8.0, -1, 1)
        hv_map[inside, 1] = np.clip((yy[inside] - cy) / 8.0, -1, 1)
    return np_map, hv_map


def many_nuclei_maps(h: int = 150, w: int = 170, seed: int = 3):
    """NP/HV/TP maps of touching nuclei with noise, types 1-4."""
    rng = np.random.default_rng(seed)
    np_map = np.zeros((h, w, 1), np.float32)
    hv_map = np.zeros((h, w, 2), np.float32)
    tp_map = np.zeros((h, w, 1), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(45):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(4, 9)
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        np_map[inside, 0] = rng.uniform(0.6, 1.0)
        hv_map[inside, 0] = np.clip((xx[inside] - cx) / r, -1, 1)
        hv_map[inside, 1] = np.clip((yy[inside] - cy) / r, -1, 1)
        tp_map[inside, 0] = rng.integers(1, 5)
    np_map += rng.normal(0, 0.05, np_map.shape).astype(np.float32)
    hv_map += rng.normal(0, 0.05, hv_map.shape).astype(np.float32)
    return np_map, hv_map, tp_map


MAPS = {
    "two nuclei 12 apart": lambda: (*two_blob_maps(12), None),
    "two nuclei 14 apart": lambda: (*two_blob_maps(14), None),
    "two nuclei 24 apart": lambda: (*two_blob_maps(24), None),
    "many nuclei": many_nuclei_maps,
    "many nuclei, edge sizes": lambda: many_nuclei_maps(97, 131, seed=8),
}


def assert_info_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key in want:
        assert set(got[key]) == set(want[key])
        for field in ("box", "centroid", "contours"):
            np.testing.assert_array_equal(got[key][field], want[key][field], err_msg=f"{key} {field}")
        assert got[key]["type"] == want[key]["type"]
        assert got[key]["prob"] == want[key]["prob"]


@pytest.mark.parametrize("name", list(MAPS))
def test_proc_np_hv_and_instance_info_equal_jax(name: str) -> None:
    np_map, hv_map, tp_map = MAPS[name]()
    want = JaxHoVerNet._proc_np_hv(np_map, hv_map)
    got = HoVerNet._proc_np_hv(np_map, hv_map)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 2
    assert_info_equal(
        HoVerNet.get_instance_info(got, tp_map, offset=(3, 7)),
        JaxHoVerNet.get_instance_info(want, tp_map, offset=(3, 7)),
    )


@pytest.mark.parametrize("name", ["two nuclei 14 apart", "many nuclei"])
def test_proc_np_energy_equals_jax(name: str) -> None:
    np_map, hv_map, _ = MAPS[name]()
    from tiatoolbox_tpu.ops.hv_energy import hv_energy

    energy = np.asarray(hv_energy(hv_map))[..., None]
    np.testing.assert_array_equal(
        HoVerNet._proc_np_energy(np_map, energy), JaxHoVerNet._proc_np_energy(np_map, energy)
    )


def _postproc_columns_equal(got: tuple, want: tuple) -> None:
    (g,), (w,) = got, want
    assert g["task_type"] == w["task_type"] and g["seg_type"] == w["seg_type"]
    np.testing.assert_array_equal(g["predictions"], w["predictions"])
    for key in ("box", "centroid", "contours", "prob", "type"):
        assert len(g["info_dict"][key]) == len(w["info_dict"][key])
        for a, b in zip(g["info_dict"][key], w["info_dict"][key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_postproc_equals_jax_on_each_input_layout() -> None:
    """[np, hv], [np, hv, tp], [np, energy, tp] and the packed uint8 plane."""
    from tiatoolbox_tpu.ops.hv_energy import hv_energy

    np_map, hv_map, tp_map = many_nuclei_maps()
    port = HoVerNet(num_types=5, mode="fast", device="cpu")
    jax_model = JaxHoVerNet(num_types=5, mode="fast")
    _postproc_columns_equal(
        HoVerNet(num_types=None, mode="fast", device="cpu").postproc([np_map, hv_map]),
        JaxHoVerNet(num_types=None, mode="fast").postproc([np_map, hv_map]),
    )
    _postproc_columns_equal(port.postproc([np_map, hv_map, tp_map]), jax_model.postproc([np_map, hv_map, tp_map]))
    energy = np.asarray(hv_energy(hv_map))[..., None]
    _postproc_columns_equal(port.postproc([np_map, energy, tp_map]), jax_model.postproc([np_map, energy, tp_map]))
    packed = ((np_map[..., 0] >= 0.5) | (np.round(tp_map[..., 0]).astype(np.uint8) << 1)).astype(np.uint8)
    _postproc_columns_equal(
        port.postproc([packed[..., None], energy]), jax_model.postproc([np_map, energy, tp_map])
    )
    assert set(port.last_postproc_seconds) == {"watershed", "instance_info"}


def test_empty_maps_give_no_instances() -> None:
    (task,) = HoVerNet(num_types=None, mode="fast", device="cpu").postproc(
        [np.zeros((40, 40, 1), np.float32), np.zeros((40, 40, 2), np.float32)]
    )
    assert task["predictions"].max() == 0 and len(task["info_dict"]["box"]) == 0


def test_host_library_is_built_with_gxx_keyed_by_source_and_flags(monkeypatch, tmp_path) -> None:
    from tiatoolbox_tpu_torch import _build

    built = _build.build("watershed.cpp")
    assert built.parent == _build.BUILD_DIR and built.name.startswith("libwatershed-")
    assert _build.ptxas_report("watershed.cpp") == []
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "h.cpp").write_text('extern "C" int seven() { return 7; }\n')
    before = _build.library_path("h.cpp")
    monkeypatch.setattr(_build, "HOST_FLAGS", (*_build.HOST_FLAGS, "-g"))
    assert _build.library_path("h.cpp") != before
    assert _build.load("h.cpp").seven() == 7
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build bad.cpp"):
        _build.build("bad.cpp")
