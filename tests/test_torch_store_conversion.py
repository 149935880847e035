"""The port's store conversion and OME-TIFF writer against JAX's.

``process_contours`` and the tracer under it (``native.find_contours_ccomp``)
give cv2's contours, hierarchy and polygons through JAX's function on seeded
masks: blobs with holes, islands in holes, 1-pixel lines, single pixels,
masks on the image's edge, several classes. Every ``dict_to_store_*`` writes
a store equal to JAX's by content (keys are uuid4 in both, so rows are
compared sorted), the QuPath JSON equals JAX's up to ids, and the OME-TIFF
heatmap equals JAX's: level 0 bit for bit, lower levels within one grey
level where a halved size is odd (the port's area resize against cv2's).
"""

from __future__ import annotations

import json

import cv2
import numpy as np
import pytest
from scipy import ndimage

from tiatoolbox_tpu.utils import misc as jmisc
from tiatoolbox_tpu.utils import store_conversion as jsc
from tiatoolbox_tpu.wsicore.tiffio import TiffFile as JaxTiffFile
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore
from tiatoolbox_tpu_torch.utils import misc as pmisc
from tiatoolbox_tpu_torch.utils import store_conversion as psc
from tiatoolbox_tpu_torch.wsicore.tiffio import TiffFile


def _disc(h, w, cy, cx, r):
    yy, xx = np.ogrid[:h, :w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 < r * r


def _named_masks() -> dict[str, np.ndarray]:
    masks = {}
    m = _disc(40, 50, 20, 25, 15) & ~_disc(40, 50, 20, 25, 6)
    masks["blob_with_hole"] = m
    m = _disc(60, 60, 30, 30, 27) & ~_disc(60, 60, 30, 30, 20)
    m |= _disc(60, 60, 30, 30, 14) & ~_disc(60, 60, 30, 30, 9)
    m |= _disc(60, 60, 30, 30, 4)
    masks["islands_in_holes"] = m
    m = np.zeros((30, 40), bool)
    m[5, 3:30] = True
    m[8:25, 12] = True
    m[np.arange(10, 20), np.arange(20, 30)] = True
    m[27, 35] = True
    masks["one_pixel_lines"] = m
    m = np.zeros((20, 20), bool)
    m[[1, 5, 5, 9, 14], [1, 5, 7, 18, 3]] = True
    masks["single_pixels"] = m
    masks["full"] = np.ones((17, 23), bool)
    m = np.zeros((25, 30), bool)
    m[:10, :] = True
    m[:, 25:] = True
    m[20:, :4] = True
    m[3:6, 10:14] = False
    masks["edge_touching"] = m
    m = np.ones((12, 12), bool)
    m[1:-1, 1:-1] = False
    masks["frame_ring"] = m
    masks["checker"] = (np.indices((9, 11)).sum(0) % 2).astype(bool)
    masks["empty"] = np.zeros((8, 8), bool)
    return masks


def _seeded_masks(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(17)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        m = rng.random((h, w)) < rng.uniform(0.1, 0.95)
        if i % 3 == 1:
            m = ndimage.binary_opening(m)
        elif i % 3 == 2:
            m = np.zeros((h, w), bool)
            for _ in range(4):
                m ^= _disc(h, w, rng.integers(0, h), rng.integers(0, w), rng.integers(1, 12))
        out.append(m)
    return out


def _cv2_ccomp(mask: np.ndarray):
    contours, hierarchy = cv2.findContours(mask.astype(np.uint8), cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)
    if hierarchy is None:
        return [], np.zeros((0, 4), np.int32)
    return [c.reshape(-1, 2) for c in contours], hierarchy[0]


MASKS = _named_masks()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_tracer_matches_cv2_on_named_masks(name: str) -> None:
    got, got_h = native.find_contours_ccomp(MASKS[name])
    want, want_h = _cv2_ccomp(MASKS[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_h, want_h)


@pytest.mark.parametrize("chunk", range(4))
def test_tracer_matches_cv2_on_seeded_masks(chunk: int) -> None:
    for mask in _seeded_masks(400)[chunk::4]:
        got, got_h = native.find_contours_ccomp(mask)
        want, want_h = _cv2_ccomp(mask)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        np.testing.assert_array_equal(got_h, want_h)


def test_tracer_matches_cv2_with_hundreds_of_contours() -> None:
    # over 125 borders: OpenCV's border labels wrap at 127
    rng = np.random.default_rng(29)
    mask = ndimage.binary_opening(rng.random((300, 260)) < 0.55)
    got, got_h = native.find_contours_ccomp(mask)
    want, want_h = _cv2_ccomp(mask)
    assert len(want) > 200
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    np.testing.assert_array_equal(got_h, want_h)


def _polygons(polys) -> list:
    return [(p.shell.tolist(), [h.tolist() for h in p.holes]) for p in polys]


@pytest.mark.parametrize("name", sorted(MASKS))
def test_process_contours_matches_jax(name: str) -> None:
    mask = MASKS[name].astype(np.uint8)
    for sf in ((1.0, 1.0), (2.0, 0.5)):
        assert _polygons(psc.process_contours(mask, 1, sf)) == _polygons(jsc.process_contours(mask, 1, sf))


def test_process_contours_matches_jax_on_several_classes() -> None:
    rng = np.random.default_rng(5)
    labels = np.zeros((64, 80), np.uint8)
    for i in range(12):
        labels[_disc(64, 80, *rng.integers(0, 80, 2), rng.integers(3, 15))] = 1 + i % 3
    for cls in range(1, 4):
        got = psc.process_contours(labels, cls, (1.5, 1.5), min_area=4)
        want = jsc.process_contours(labels, cls, (1.5, 1.5), min_area=4)
        assert len(got) > 0
        assert _polygons(got) == _polygons(want)


def _rows(store_or_path) -> list:
    store = SQLiteStore(store_or_path) if not hasattr(store_or_path, "values") else store_or_path
    return sorted(
        (a.geometry.to_wkb(), json.dumps(a.properties, sort_keys=True)) for a in store.values()
    )


def _patch_output(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 2000, (40, 2))
    probs = rng.random((40, 9))
    probs /= probs.sum(1, keepdims=True)
    return {
        "coordinates": np.concatenate([xy, xy + 224], axis=1),
        "predictions": probs.argmax(1),
        "probabilities": probs,
        "labels": rng.integers(0, 9, 40),
    }


CLASSES = {i: f"class{i}" for i in range(9)}


@pytest.mark.parametrize("class_dict", [None, CLASSES])
def test_patch_prediction_stores_match_jax(tmp_path, class_dict) -> None:
    out = _patch_output(3)
    got = psc.dict_to_store_patch_predictions(out, (2.0, 2.0), class_dict, tmp_path / "port.db")
    want = jsc.dict_to_store_patch_predictions(out, (2.0, 2.0), class_dict, tmp_path / "jax.db")
    assert got == tmp_path / "port.db"
    assert _rows(got) == _rows(want)
    in_memory = psc.dict_to_store_patch_predictions(out, class_dict=class_dict)
    assert _rows(in_memory) == _rows(jsc.dict_to_store_patch_predictions(out, class_dict=class_dict))


@pytest.mark.parametrize("offset", [(0, 0), (100, 37)])
def test_semantic_stores_match_jax(tmp_path, offset) -> None:
    rng = np.random.default_rng(8)
    preds = np.zeros((96, 128), np.uint8)
    for i in range(15):
        preds[_disc(96, 128, *rng.integers(0, 128, 2), rng.integers(3, 20))] = 1 + i % 3
    names = {1: "tumour", 2: "stroma", 3: "necrosis"}
    got = psc.dict_to_store_semantic_segmentor(
        {"predictions": preds}, (4.0, 4.0), names, tmp_path / "port.db", offset=offset
    )
    want = jsc.dict_to_store_semantic_segmentor(
        {"predictions": preds}, (4.0, 4.0), names, tmp_path / "jax.db", offset=offset
    )
    assert len(_rows(got)) > 5
    assert _rows(got) == _rows(want)


def _instances(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(30):
        c = rng.uniform(10, 500, 2)
        t = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(2, 9))))
        contour = np.round(c + 6 * np.stack([np.cos(t), np.sin(t)], -1)).astype(np.int32)
        out[f"id{i}"] = {
            "box": np.concatenate([contour.min(0), contour.max(0)]),
            "centroid": c,
            "contours": contour,
            "prob": float(rng.random()),
            "type": int(rng.integers(0, 6)) if i % 7 else None,
        }
    return out


@pytest.mark.parametrize("class_dict", [None, {i: f"t{i}" for i in range(6)}])
def test_instance_and_detection_stores_match_jax(tmp_path, class_dict) -> None:
    inst = _instances(4)
    got = psc.dict_to_store_instance_segmentor(inst, (2.0, 2.0), class_dict, tmp_path / "p.db")
    want = jsc.dict_to_store_instance_segmentor(inst, (2.0, 2.0), class_dict, tmp_path / "j.db")
    assert sorted(SQLiteStore(got).keys()) == sorted(SQLiteStore(want).keys())
    assert _rows(got) == _rows(want)
    rng = np.random.default_rng(6)
    det = {"coordinates": rng.uniform(0, 900, (25, 2)), "scores": rng.random(25), "types": rng.integers(0, 6, 25)}
    assert _rows(psc.dict_to_store_nucleus_detector(det, (0.5, 0.5), class_dict)) == _rows(
        jsc.dict_to_store_nucleus_detector(det, (0.5, 0.5), class_dict)
    )


@pytest.mark.parametrize("n_classes", [1, 2, 5, 9, 20, 23])
def test_patch_qupath_json_matches_jax(n_classes: int) -> None:
    out = _patch_output(9)
    class_dict = {i: f"c{i}" for i in range(n_classes)}
    preds = out["predictions"] % n_classes
    got = psc.patch_predictions_as_qupath_json(preds, class_dict, out["coordinates"])
    want = jsc.patch_predictions_as_qupath_json(preds, class_dict, out["coordinates"])
    assert got == want


def test_store_qupath_json_matches_jax(tmp_path) -> None:
    inst = _instances(12)
    got = psc.store_to_qupath_json(psc.dict_to_store_instance_segmentor(inst), tmp_path / "p.json")
    want = jsc.store_to_qupath_json(jsc.dict_to_store_instance_segmentor(inst), tmp_path / "j.json")

    def features(path):
        return sorted(json.dumps(f, sort_keys=True) for f in json.loads(path.read_text())["features"])

    assert features(got) == features(want)
    assert json.loads(got.read_text())["type"] == "FeatureCollection"


def test_colour_tables_are_what_the_script_writes() -> None:
    import importlib.util
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "scripts" / "make_colormaps.py"
    spec = importlib.util.spec_from_file_location("make_colormaps", script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fresh = module.tables()
    committed = psc.colour_tables()
    assert sorted(fresh) == sorted(committed)
    for name, table in fresh.items():
        np.testing.assert_array_equal(committed[name], table)
    # applyColorMap of an image is the table's lookup
    img = np.random.default_rng(2).integers(0, 256, (13, 17), dtype=np.uint8)
    np.testing.assert_array_equal(committed["cv2_2"][img], cv2.applyColorMap(img, 2)[..., ::-1])


def _levels(reader_cls, path) -> list[np.ndarray]:
    tif = reader_cls(path)
    return [tif.read_region(i, (0, 0), (p.width, p.height)) for i, p in enumerate(tif.pages)]


@pytest.mark.parametrize(
    ("hw", "colormap"), [((600, 900), None), ((601, 899), 2), ((257, 513), 11), ((700, 520), 0)]
)
def test_ome_tiff_heatmap_matches_jax(tmp_path, hw, colormap) -> None:
    prob = np.random.default_rng(hw[0]).random(hw).astype(np.float32)
    got = pmisc.write_probability_heatmap_as_ome_tiff(tmp_path / "p.ome.tiff", prob, colormap, mpp=(0.5, 0.5))
    want = jmisc.write_probability_heatmap_as_ome_tiff(tmp_path / "j.ome.tiff", prob, colormap, mpp=(0.5, 0.5))
    got_levels, want_levels = _levels(TiffFile, got), _levels(JaxTiffFile, want)
    assert [g.shape for g in got_levels] == [w.shape for w in want_levels]
    assert TiffFile(got).pages[0].description == JaxTiffFile(want).pages[0].description
    np.testing.assert_array_equal(got_levels[0], want_levels[0])
    for level, (g, w) in enumerate(zip(got_levels[1:], want_levels[1:]), start=1):
        above = want_levels[level - 1].shape[:2]
        if above[0] % 2 == 0 and above[1] % 2 == 0:
            np.testing.assert_array_equal(g, w)
        else:
            assert int(np.abs(g.astype(int) - w.astype(int)).max()) <= 1
