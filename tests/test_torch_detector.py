"""Nucleus detection: the port's peak tools and ``NucleusDetector`` against JAX on the CPU.

The peak tools run on the host with the same numpy and scipy calls in the
same order as JAX's, so their peaks, their order (ties included) and the
NMS survivors are JAX's exactly; so are ``_detect`` and ``post_process_wsi``
on the same numpy canvas (coordinates, scores and types), across the
4096-row band seam and with ``threshold_rel``.

The engines run MapDe (``mapde-conic``'s network, full width, 252^2
patches at stride 150) and SCCNN (``sccnn-crchisto``'s, 31^2 patches, 13^2
outputs at stride 8) with seeded random flax variables carried into the
port by the converters, in patch mode and on small synthetic slides. The
stitched canvases agree within 1e-4 of their largest value (the forwards
sum convolutions in another order); the detections of the port's canvas
equal those of JAX's ``post_process_wsi`` on that canvas. The random
weights give maps far below the registry thresholds, so each run sets
``threshold_abs`` from the canvas. The writers' files read back to the
detections: zarr arrays bit for bit, one point annotation each in the
store, QuPath JSON equal to JAX's helper's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from scipy import ndimage

from test_torch_micronet import random_variables
from tiatoolbox_tpu.models.architecture.mapde import MapDe as JaxMapDe
from tiatoolbox_tpu.models.architecture.sccnn import SCCNN as JaxSCCNN
from tiatoolbox_tpu.models.architecture.utils import nms_on_detection_maps as jax_nms
from tiatoolbox_tpu.models.architecture.utils import peak_detection_map_overlap as jax_peaks
from tiatoolbox_tpu.models.engine import nucleus_detector as jax_detector
from tiatoolbox_tpu.models.engine.io_config import IOSegmentorConfig as JaxIOConfig
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture.mapde import MapDe
from tiatoolbox_tpu_torch.models.architecture.sccnn import SCCNN
from tiatoolbox_tpu_torch.models.architecture.utils import nms_on_detection_maps, peak_detection_map_overlap
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_mapde_to_torch, flax_sccnn_to_torch
from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, NucleusDetector
from tiatoolbox_tpu_torch.models.engine import nucleus_detector as port_detector
from tiatoolbox_tpu_torch.utils.zarrlite import open_zarr

CANVAS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _smooth_map(shape, seed: int, sigma: float = 2.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.random(shape), sigma).astype(np.float32)


def _maps() -> dict:
    """Seeded maps: smooth, with plateaus, with exact ties, quantised, empty."""
    smooth = _smooth_map((150, 130), 1)
    plateau = smooth.copy()
    plateau[20:26, 20:26] = smooth.max()  # a flat top
    plateau[60:62, 90:93] = smooth.max()  # its tie elsewhere
    quantised = np.round(_smooth_map((97, 111), 2, sigma=1.5) * 20) / 20  # many equal values
    ties = np.zeros((40, 40), np.float32)
    ties[5::9, 7::11] = 1.0  # equal isolated peaks
    return {"smooth": smooth, "plateau": plateau, "quantised": quantised, "ties": ties, "empty": np.zeros((30, 20), np.float32)}


@pytest.mark.parametrize("name", list(_maps()))
@pytest.mark.parametrize(("min_distance", "threshold"), [(3, 0.5), (6, 0.45), (1, 0.0)])
def test_peak_tools_match_jax(name: str, min_distance: int, threshold: float) -> None:
    m = _maps()[name]
    got = peak_detection_map_overlap(m, min_distance=min_distance, threshold_abs=threshold)
    want = jax_peaks(m, min_distance=min_distance, threshold_abs=threshold)
    np.testing.assert_array_equal(got, want)
    scores = m[got[:, 0], got[:, 1]] if len(got) else np.zeros(0, np.float32)
    np.testing.assert_array_equal(
        nms_on_detection_maps(got, scores, radius=min_distance), jax_nms(want, scores, radius=min_distance)
    )


def _engines(port_model, jax_model, **params):
    port = NucleusDetector(port_model, batch_size=4, num_loader_workers=0, verbose=False, device="cpu")
    jax = jax_detector.NucleusDetector(jax_model, batch_size=4, num_loader_workers=0, verbose=False)
    for engine in (port, jax):
        for key, value in params.items():
            setattr(engine, key, value)
    return port, jax


@pytest.fixture(scope="module")
def sccnn_pair():
    jax_model = JaxSCCNN(min_distance=6, threshold_abs=0.2, class_dict={0: "nucleus"})
    variables = random_variables(jax_model.module, 31, seed=12)
    jax_model.load_weights(variables)
    port = SCCNN(min_distance=6, threshold_abs=0.2, class_dict={0: "nucleus"}, device="cpu")
    port.load_state_dict(flax_sccnn_to_torch(variables))
    return port, jax_model


def _assert_detections_equal(got: dict, want: dict) -> None:
    for key in ("coordinates", "scores", "types"):
        assert np.asarray(got[key]).shape == np.asarray(want[key]).shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _three_channel_canvas(h: int = 8400, w: int = 96) -> np.ndarray:
    """A tall canvas with peaks on and around both 4096-row band seams."""
    canvas = np.stack([_smooth_map((h, w), s, sigma=2.5) for s in (3, 4, 5)], axis=-1)
    for row in (4090, 4095, 4096, 4100, 8190, 8192, 8200):
        if row < h:
            canvas[row, 40, 0] = 1.0
    return canvas


@pytest.mark.parametrize(
    "params",
    [
        {},
        {"threshold_abs": 0.52},
        {"threshold_abs": 0.4, "threshold_rel": 0.97},
        {"min_distance": 2, "threshold_abs": 0.55, "postproc_tile_shape": (1000, 1000)},
    ],
)
def test_detect_and_post_process_wsi_match_jax(sccnn_pair, params: dict) -> None:
    port, jax_engine = _engines(*sccnn_pair, **params)
    canvas = _three_channel_canvas()
    got = port.post_process_wsi({"probabilities": canvas})
    want = jax_engine.post_process_wsi({"probabilities": canvas})
    _assert_detections_equal(got, want)
    assert len(got["coordinates"]) > 10 and set(np.unique(got["types"])) == {0, 1, 2}
    rows = got["coordinates"][:, 1]
    assert ((rows >= 4090) & (rows <= 4100)).any()  # peaks at the seam are found once
    found = {(*c, t) for c, t in zip(got["coordinates"].tolist(), got["types"].tolist())}
    assert len(found) == len(got["coordinates"])  # no band finds a peak of another
    _assert_detections_equal(port._detect(canvas[:500]), jax_engine._detect(canvas[:500]))
    _assert_detections_equal(port._detect(canvas[:500, :, 1]), jax_engine._detect(canvas[:500, :, 1]))


def test_run_param_precedence(sccnn_pair) -> None:
    """Run kwargs, then the model's attributes, then 6 / 0.5."""
    port, _ = _engines(*sccnn_pair)
    canvas = _smooth_map((600, 80), 9)[..., None] * 0.5  # about 0.25
    canvas[100::100, 20] = 0.9
    canvas[150::100, 60] = 0.55
    by_model = port._detect(canvas)  # the model's 6 / 0.2
    port.run(np.zeros((1, 31, 31, 3), np.uint8), patch_mode=True, threshold_abs=0.6, min_distance=3)
    assert (port.threshold_abs, port.min_distance) == (0.6, 3)
    by_run = port._detect(canvas)
    assert len(by_run["scores"]) == 5 and by_run["scores"].min() > 0.6
    assert len(by_model["scores"]) > len(by_run["scores"])
    bare = NucleusDetector(SCCNN(device="cpu"), device="cpu", verbose=False)
    del bare.model.min_distance, bare.model.threshold_abs  # a model without the attributes
    got = bare._detect(canvas)
    assert len(got["scores"]) == 10 and got["scores"].min() > 0.5


@pytest.fixture(scope="module")
def sccnn_slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("det") / "sccnn.tiff"
    make_synthetic_slide(path, size=(200, 168), mpp=0.25, objective_power=40, seed=7, compression="deflate")
    return str(path)


class _Recording:
    """Keeps the canvas handed to ``post_process_wsi``."""

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:
        self.canvas = np.array(raw_predictions["probabilities"])
        return super().post_process_wsi(raw_predictions, **kwargs)


class _PortRecording(_Recording, NucleusDetector):
    pass


class _JaxRecording(_Recording, jax_detector.NucleusDetector):
    pass


def _io(name: str, cls):
    return cls(**PRETRAINED_MODELS[name]["ioconfig"]["kwargs"])


def _run_slide(port_model, jax_model, slide: str, name: str, threshold_from: float, batch_size: int = 8):
    """Both engines on ``slide``; the port's detections, JAX's detections of the
    port's canvas, and both engines (which keep their canvases)."""
    port = _PortRecording(port_model, batch_size=batch_size, num_loader_workers=0, verbose=False, device="cpu")
    jax = _JaxRecording(jax_model, batch_size=batch_size, num_loader_workers=0, verbose=False)
    common = dict(patch_mode=False, auto_get_mask=False)
    jax.run([slide], ioconfig=_io(name, JaxIOConfig), **common)
    threshold = float(np.quantile(jax.canvas, threshold_from))
    jax_engine = jax_detector.NucleusDetector(jax_model, verbose=False)
    jax_engine.threshold_abs = threshold
    got = port.run([slide], ioconfig=_io(name, IOSegmentorConfig), threshold_abs=threshold, **common)[slide]
    return got, jax_engine.post_process_wsi({"probabilities": port.canvas}), port, jax


def test_sccnn_slide_matches_jax(sccnn_pair, sccnn_slide) -> None:
    got, want, port, jax = _run_slide(*sccnn_pair, sccnn_slide, "sccnn-crchisto", threshold_from=0.995)
    assert port.last_stage_summary["path"] == "device-canvas"  # SCCNN's own preproc: no region feed
    assert port.canvas.shape == jax.canvas.shape == (168, 200, 1)
    scale = float(np.abs(jax.canvas).max())
    assert float(np.abs(port.canvas - jax.canvas).max()) <= CANVAS_TOL * scale
    _assert_detections_equal(got, want)
    assert len(got["coordinates"]) > 3


@pytest.fixture(scope="module")
def mapde_pair():
    jax_model = JaxMapDe(min_distance=3, threshold_abs=205, num_classes=1)
    variables = random_variables(jax_model.module, 252, seed=13)
    jax_model.load_weights(variables)
    port = MapDe(min_distance=3, threshold_abs=205, device="cpu")
    port.load_state_dict(flax_mapde_to_torch(variables))
    return port, jax_model


def test_mapde_slide_and_patches_match_jax(mapde_pair, tmp_path) -> None:
    path = make_synthetic_slide(tmp_path / "mapde.tiff", size=(402, 252), mpp=0.5, seed=8, compression="deflate")
    got, want, port, jax = _run_slide(*mapde_pair, str(path), "mapde-conic", threshold_from=0.999, batch_size=1)
    n_patches = len(port.get_dataloader(str(path), ioconfig=_io("mapde-conic", IOSegmentorConfig), patch_mode=False).dataset)
    assert n_patches >= 2  # the canvas has overlapping patches
    assert port.last_stage_summary["path"] == "device-canvas"  # MapDe's own identity preproc
    assert port.canvas.shape == jax.canvas.shape == (252, 402, 1)
    scale = float(np.abs(jax.canvas).max())
    assert float(np.abs(port.canvas - jax.canvas).max()) <= CANVAS_TOL * scale
    _assert_detections_equal(got, want)
    assert len(got["coordinates"]) > 3
    # patch mode: each patch's map and its detections
    patches = synthetic_he_patch((252, 252), seed=1)[None]
    port_engine, jax_engine = _engines(*mapde_pair)
    port_engine.batch_size = jax_engine.batch_size = 1
    out_p = port_engine.run(patches, patch_mode=True)
    out_j = jax_engine.run(patches, patch_mode=True)
    assert float(np.abs(out_p["probabilities"] - out_j["probabilities"]).max()) <= CANVAS_TOL * float(
        np.abs(out_j["probabilities"]).max()
    )
    threshold = float(np.quantile(out_p["probabilities"], 0.999))
    port_engine.threshold_abs = jax_engine.threshold_abs = threshold
    want = jax_engine._detect(out_p["probabilities"][0])
    _assert_detections_equal(port_engine._detect(out_p["probabilities"][0]), want)
    assert len(out_p["detections"]) == 1 and len(want["scores"]) > 0


def test_outputs_read_back(sccnn_pair, sccnn_slide, tmp_path) -> None:
    port_model, _ = sccnn_pair
    engine = NucleusDetector(port_model, batch_size=8, num_loader_workers=0, verbose=False, device="cpu")
    common = dict(patch_mode=False, auto_get_mask=False, ioconfig=_io("sccnn-crchisto", IOSegmentorConfig))
    dets = engine.run([sccnn_slide], threshold_abs=0.0, min_distance=3, **common)[sccnn_slide]
    n = len(dets["coordinates"])
    assert n > 10
    stem = "sccnn"
    zarr_path = engine.run(
        [sccnn_slide], save_dir=tmp_path / "z", output_type="zarr", threshold_abs=0.0, **common
    )[sccnn_slide]
    assert zarr_path == tmp_path / "z" / f"{stem}.zarr"
    group = open_zarr(zarr_path)
    for key in ("coordinates", "scores", "types"):
        np.testing.assert_array_equal(np.asarray(group[key]), dets[key])
    db = engine.run([sccnn_slide], save_dir=tmp_path / "s", output_type="annotationstore", **common)[sccnn_slide]
    assert db == tmp_path / "s" / f"{stem}.db"
    store = SQLiteStore(db)
    points = sorted((a.geometry.x, a.geometry.y, a.properties["type"], a.properties["prob"]) for a in store.values())
    store.close()
    scale = engine._calculate_scale_factor(engine.get_dataloader(sccnn_slide, ioconfig=common["ioconfig"], patch_mode=False))
    want = sorted(
        (float(x * scale[0]), float(y * scale[1]), "nucleus", float(s))
        for (x, y), s in zip(dets["coordinates"], dets["scores"])
    )
    assert points == want
    qp = engine.run([sccnn_slide], save_dir=tmp_path / "q", output_type="qupath", **common)[sccnn_slide]
    assert qp == tmp_path / "q" / f"{stem}.json"
    class_dict = port_model.class_dict
    want_json = jax_detector.save_detection_arrays_to_qupath_json(dets, scale_factor=scale, class_dict=class_dict)
    assert json.loads(qp.read_text()) == want_json
    # the helpers, against JAX's
    got_json = port_detector.save_detection_arrays_to_qupath_json(dets, scale_factor=scale, class_dict=class_dict)
    assert got_json == want_json
    store = port_detector.save_detection_arrays_to_store(dets, scale_factor=scale, class_dict=class_dict)
    assert len(store) == n
    points = port_detector.make_points(dets["coordinates"][:, 0], dets["coordinates"][:, 1])
    assert [(p.x, p.y) for p in points] == [(float(x), float(y)) for x, y in dets["coordinates"]]


def test_spilled_canvas_gives_the_same_detections(sccnn_pair, sccnn_slide, tmp_path) -> None:
    """A host canvas spilled to zarr is read band by band: the detections
    equal the device canvas's."""

    class HostCanvas(NucleusDetector):
        def _device_canvas_budget_bytes(self) -> int:
            return 0

    port_model, _ = sccnn_pair
    common = dict(patch_mode=False, auto_get_mask=False, ioconfig=_io("sccnn-crchisto", IOSegmentorConfig))
    params = dict(threshold_abs=0.0, min_distance=3, postproc_tile_shape=(50, 50))
    device = NucleusDetector(port_model, batch_size=8, num_loader_workers=0, verbose=False, device="cpu")
    want = device.run([sccnn_slide], **params, **common)[sccnn_slide]
    spill = HostCanvas(port_model, batch_size=8, num_loader_workers=0, verbose=False, device="cpu")
    got = spill.run([sccnn_slide], save_dir=tmp_path / "out", memory_threshold=0.0, **params, **common)[sccnn_slide]
    assert spill.last_stage_summary["path"] == "host-canvas" and spill.spill_bytes > 0
    assert not (tmp_path / "out" / "cache").exists()
    _assert_detections_equal(got, want)
    assert len(got["coordinates"]) > 10
