"""The multitask engine's drained views and HoVer-Net's scratch pool, on the CPU.

- ``MultiTaskSegmentor`` hands ``post_process_wsi`` ``LazyRowsView``s of its
  drains on every device-canvas path (the region feed's uint8 plane and
  energy, the per-patch feed's ``[np, energy, tp]``, tile mode's raw maps);
  the instances are identical when the same maps come as arrays. Each
  drain's stage reads its overlap from when its last row landed and when
  post-processing started (``drain_stage``). The model
  is ``tests/test_torch_parallel.py``'s HoVer-Net with closed-form heads, so
  no full-width forward runs here.
- ``HoVerNet.postproc`` labels the foreground before it reads a row of the
  energy: a view whose watermark is held back keeps it waiting only after
  the labelling, in each input layout.
- The pooled ``_proc_np_hv`` and ``_proc_np_energy`` equal JAX's bit for
  bit on seeded maps, call after call on one thread's pool; each helper
  given ``out=`` equals its result without one (and cv2's).
- The pool: the same buffers per shape and thread, separate between
  threads, emptied for a new shape and dropped above 256 MiB.
- ``ModelABC.load_weights_from_file`` and ``ModelABC.load_torch_model``:
  a seeded ``.pth`` and a converted flax ``.npz`` give the outputs of the
  module's ``load_torch_model``.
"""

from __future__ import annotations

import threading
import time

import cv2
import numpy as np
import pytest
import torch

from test_torch_instance_postproc import many_nuclei_maps, two_blob_maps
from test_torch_parallel import _ClosedFormHoVerNet
from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
from tiatoolbox_tpu.ops.hv_energy import hv_energy as jax_hv_energy
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture import hovernet
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
from tiatoolbox_tpu_torch.models.engine import IOInstanceSegmentorConfig, MultiTaskSegmentor
from tiatoolbox_tpu_torch.models.engine.multi_task_segmentor import drain_stage
from tiatoolbox_tpu_torch.ops.hv_energy import hv_energy
from tiatoolbox_tpu_torch.parallel.pipeline import LazyRowsView, RowWatermark
from tiatoolbox_tpu_torch.tools.tissuemask import ellipse_kernel

WAIT_S = 10.0

IOCONFIG = dict(
    input_resolutions=[{"units": "mpp", "resolution": 0.25}],
    output_resolutions=[{"units": "mpp", "resolution": 0.25}],
    patch_input_shape=(256, 256),
    patch_output_shape=(164, 164),
    stride_shape=(164, 164),
    margin=64,
    tile_shape=(2048, 2048),
    save_resolution={"units": "mpp", "resolution": 0.25},
)


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("views") / "slide.tiff"
    make_synthetic_slide(path, size=(600, 440), mpp=0.25, objective_power=40, compression="deflate")
    return str(path)


def _rows(instances: dict) -> list:
    return sorted(
        (np.asarray(v["box"]).tolist(), np.asarray(v["centroid"], float).tolist(),
         np.asarray(v["contours"]).tolist(), v["type"], v["prob"])
        for v in instances.values()
    )


PATHS = {
    "region feed": ({}, {}, "multitask-device-canvas+region-feed+banded-u8+device-energy", ("fetch-banded", "fetch")),
    "per patch": ({"region_feed": False}, {}, "multitask-device-canvas+device-energy", ("fetch",)),
    "tile mode": (
        {}, {"full_postproc_limit": 100_000, "tile_shape": (256, 256)}, "multitask-device-canvas+region-feed",
        ("fetch",),
    ),
}


@pytest.mark.parametrize("name", list(PATHS))
def test_engine_instances_equal_with_views_and_arrays(slide, name: str) -> None:
    run_kwargs, attrs, path, drains = PATHS[name]
    seg = MultiTaskSegmentor(_ClosedFormHoVerNet(), batch_size=8, num_loader_workers=0, device="cpu", verbose=False)
    for key, value in attrs.items():
        setattr(seg, key, value)
    seen: dict = {}
    post_process = seg.post_process_wsi

    def twice(raw: dict, **kwargs) -> dict:
        seen["maps"] = list(raw["head_maps"])
        seen["views"] = post_process(raw, **kwargs)
        seen["summary"] = dict(seg.last_stage_summary)
        seen["arrays"] = post_process({**raw, "head_maps": [np.asarray(m) for m in raw["head_maps"]]}, **kwargs)
        return seen["views"]

    seg.post_process_wsi = twice
    seg.run([slide], patch_mode=False, ioconfig=IOInstanceSegmentorConfig(**IOCONFIG), auto_get_mask=False,
            **run_kwargs)
    assert seen["summary"]["path"] == path
    assert all(isinstance(m, LazyRowsView) for m in seen["maps"])
    for drain in drains:
        stage = seen["summary"][drain]
        assert _overlap_agrees(stage)
        assert 0 <= stage["seconds"] and isinstance(stage["after_flush_seconds"], float)
    # the dispatch moves no items: a rate from its seconds would be no transfer rate
    assert "items" not in seen["summary"]["fetch-dispatch"]
    views, arrays = _rows(seen["views"]["instances"]), _rows(seen["arrays"]["instances"])
    assert views == arrays and len(views) > 5


def test_return_predictions_materialises_the_views(slide) -> None:
    seg = MultiTaskSegmentor(_ClosedFormHoVerNet(), batch_size=8, num_loader_workers=0, device="cpu", verbose=False)
    out = seg.run([slide], patch_mode=False, ioconfig=IOInstanceSegmentorConfig(**IOCONFIG), auto_get_mask=False,
                  return_predictions=True)[slide]
    assert [type(m) for m in out["predictions"]] == [np.ndarray] * 3
    assert [m.shape for m in out["predictions"]] == [(440, 600, 1), (440, 600, 2), (440, 600, 1)]
    assert _overlap_agrees(seg.last_stage_summary["fetch"])


def _overlap_agrees(stage: dict) -> bool:
    """The flag and the (rounded) seconds from post-processing's start to the last row agree."""
    landed = stage["landed_after_postproc_start_seconds"]
    return landed >= 0 if stage["overlapped_with_postproc"] else landed <= 0


@pytest.mark.parametrize("lands", ["before", "after"])
def test_drain_stage_reads_the_overlap_from_the_marks(lands: str) -> None:
    """Overlapped means the last row landed after post-processing started."""
    wm = RowWatermark([slice(0, 2), slice(2, 4)], 4)
    wm._mark(0)
    flushed = time.perf_counter()
    if lands == "before":
        wm._mark(1)
    time.sleep(0.01)
    start = time.perf_counter()
    time.sleep(0.01)
    if lands == "after":
        wm._mark(1)
    stage = drain_stage(wm, 16, flushed, start)
    assert stage["overlapped_with_postproc"] is (lands == "after")
    assert (stage["landed_after_postproc_start_seconds"] > 0) is (lands == "after")
    assert stage["after_flush_seconds"] == round(wm.finished_at - flushed, 4) >= 0
    assert stage["seconds"] == round(wm.drain_seconds, 4) and stage["items"] == 16


# -- HoVerNet.postproc reads the energy last ------------------------------------------


def _ready_view(arr: np.ndarray) -> LazyRowsView:
    wm = RowWatermark([slice(0, arr.shape[0])], arr.shape[0])
    wm._mark(0)
    return LazyRowsView(arr, wm, slice(0, arr.shape[-1]))


def _held_view(arr: np.ndarray) -> tuple[LazyRowsView, RowWatermark, np.ndarray]:
    """A view of an empty buffer that lands (``arr`` copied in) when its watermark is marked."""
    buf = np.full_like(arr, np.nan if arr.dtype.kind == "f" else 0)
    wm = RowWatermark([slice(0, arr.shape[0])], arr.shape[0])
    return LazyRowsView(buf, wm, slice(0, arr.shape[-1])), wm, buf


def _layouts():
    np_map, hv_map, tp_map = many_nuclei_maps()
    energy = hv_energy(torch.from_numpy(hv_map))[..., None].numpy()
    packed = ((np_map[..., 0] >= 0.5) | (np.round(tp_map[..., 0]).astype(np.uint8) << 1)).astype(np.uint8)
    return {
        "packed plane and energy": ([packed[..., None], energy], [False, True]),
        "np, energy and tp": ([np_map, energy, tp_map], [False, True, True]),
    }


@pytest.mark.parametrize("layout", ["packed plane and energy", "np, energy and tp"])
def test_postproc_labels_the_foreground_before_reading_the_energy(monkeypatch, layout: str) -> None:
    maps, held = _layouts()[layout]
    model = HoVerNet(num_types=5, mode="fast", device="cpu")
    (want,) = model.postproc(maps)
    labelled = threading.Event()
    label = hovernet._foreground_labels

    def recording(*args, **kwargs):
        out = label(*args, **kwargs)
        labelled.set()
        return out

    monkeypatch.setattr(hovernet, "_foreground_labels", recording)
    views, gates = [], []
    for arr, is_held in zip(maps, held):
        if is_held:
            view, wm, buf = _held_view(arr)
            gates.append((wm, buf, arr))
            views.append(view)
        else:
            views.append(_ready_view(arr))
    got: list = []
    thread = threading.Thread(target=lambda: got.append(model.postproc(views)), daemon=True)
    thread.start()
    assert labelled.wait(WAIT_S)
    thread.join(0.2)
    assert thread.is_alive() and not got  # labelled, now waiting for the energy
    for wm, buf, arr in gates:
        buf[...] = arr
        wm._mark(0)
    thread.join(WAIT_S)
    assert not thread.is_alive()
    ((task,),) = got
    np.testing.assert_array_equal(task["predictions"], want["predictions"])
    for key in ("box", "centroid", "contours", "type", "prob"):
        assert len(task["info_dict"][key]) == len(want["info_dict"][key]) > 20
        for a, b in zip(task["info_dict"][key], want["info_dict"][key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_hovernetplus_keeps_the_nuclei_maps_lazy(monkeypatch) -> None:
    from tiatoolbox_tpu_torch.models.architecture.hovernetplus import HoVerNetPlus

    assert HoVerNetPlus.postproc_accepts_views
    np_map, hv_map, tp_map = many_nuclei_maps()
    energy = hv_energy(torch.from_numpy(hv_map))[..., None].numpy()
    ls_map = (np_map > 0.5).astype(np.float32)
    model = HoVerNetPlus(num_types=5, num_layers=2, device="cpu")
    want = model.postproc([np_map, energy, tp_map, ls_map])
    energy_view, wm, buf = _held_view(energy)
    labelled = threading.Event()
    label = hovernet._foreground_labels
    monkeypatch.setattr(hovernet, "_foreground_labels", lambda *a, **k: (label(*a, **k), labelled.set())[0])
    got: list = []
    maps = [_ready_view(np_map), energy_view, _ready_view(tp_map), _ready_view(ls_map)]
    thread = threading.Thread(target=lambda: got.append(model.postproc(maps)), daemon=True)
    thread.start()
    assert labelled.wait(WAIT_S)
    thread.join(0.2)
    assert thread.is_alive()
    buf[...] = energy
    wm._mark(0)
    thread.join(WAIT_S)
    assert not thread.is_alive()
    for task, want_task in zip(got[0], want):
        np.testing.assert_array_equal(task["predictions"], want_task["predictions"])


# -- the scratch pool ------------------------------------------------------------------


def test_pooled_post_processing_equals_jax_call_after_call() -> None:
    """One thread's pool through several same-shaped calls and a new shape:
    every result equals JAX's bit for bit and none aliases the pool."""
    cases = [many_nuclei_maps(seed=s) for s in (3, 4)] + [many_nuclei_maps(97, 131, seed=8), many_nuclei_maps()]
    results = []
    for np_map, hv_map, _ in cases:
        got = HoVerNet._proc_np_hv(np_map, hv_map)
        np.testing.assert_array_equal(got, JaxHoVerNet._proc_np_hv(np_map, hv_map))
        energy = np.asarray(jax_hv_energy(hv_map))[..., None]
        # the energy as the per-patch feed's [np, energy, tp] buffer gives it: strided
        strided = np.concatenate([np_map, energy, np_map], axis=-1)[..., 1:2]
        got_e = HoVerNet._proc_np_energy(np_map, strided)
        np.testing.assert_array_equal(got_e, JaxHoVerNet._proc_np_energy(np_map, energy))
        results.append((got.copy(), got, got_e.copy(), got_e))
    for kept, got, kept_e, got_e in results:
        np.testing.assert_array_equal(kept, got)
        np.testing.assert_array_equal(kept_e, got_e)
    assert set(hovernet._SCRATCH.bufs) >= {"i32_a", "i32_b", "f32_a", "f32_b", "f64_a", "f64_b", "f64_c", "u8_a"}
    assert hovernet._SCRATCH.shape == (150, 170)  # the last case's


def test_two_blob_maps_through_the_pool_equal_jax() -> None:
    for sep in (12, 14, 24):
        np_map, hv_map = two_blob_maps(sep)
        np.testing.assert_array_equal(HoVerNet._proc_np_hv(np_map, hv_map), JaxHoVerNet._proc_np_hv(np_map, hv_map))


@pytest.mark.parametrize("shape", [(67, 53), (300, 270), (1, 9), (257, 5)])
def test_helpers_into_out_equal_their_fresh_results_and_cv2(shape) -> None:
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    x32 = (rng.normal(size=shape) * 3).astype(np.float32)
    x64 = rng.normal(size=shape)
    sc = hovernet._proc_scratch(shape)
    out32 = sc["f32_a"]
    np.testing.assert_array_equal(hovernet.normalize_minmax(x32, out=out32), hovernet.normalize_minmax(x32))
    np.testing.assert_array_equal(out32, cv2.normalize(x32, None, 0, 1, cv2.NORM_MINMAX, cv2.CV_32F))
    np.testing.assert_array_equal(
        hovernet.normalize_minmax(x64, out=sc["f32_b"]), cv2.normalize(x64, None, 0, 1, cv2.NORM_MINMAX, cv2.CV_32F)
    )
    if min(shape) > 1:
        for dx, dy in ((1, 0), (0, 1)):
            got = hovernet.sobel(x32, dx, dy, 21, out=sc["f64_a"])
            np.testing.assert_array_equal(got, cv2.Sobel(x32, cv2.CV_64F, dx, dy, ksize=21))
            np.testing.assert_array_equal(got, hovernet.sobel(x32, dx, dy, 21))
        np.testing.assert_array_equal(hovernet.gaussian_blur_3x3(x64, out=sc["f64_b"]), cv2.GaussianBlur(x64, (3, 3), 0))
    mask = (rng.random(shape) < 0.6).astype(np.uint8)
    kernel = ellipse_kernel((5, 5))
    np.testing.assert_array_equal(
        hovernet.binary_open(mask, kernel, out=sc["u8_b"]),
        cv2.morphologyEx(mask, cv2.MORPH_OPEN, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))),
    )
    marker = mask.astype(np.int32)
    np.testing.assert_array_equal(hovernet.fill_holes(marker, out=sc["u8_a"]), hovernet.fill_holes(marker))
    labelled = cv2.connectedComponents(mask, connectivity=4)[1].astype(np.int32)
    want = hovernet._remove_small_objects(labelled, 4)
    np.testing.assert_array_equal(hovernet._remove_small_objects(labelled, 4, out=sc["i32_a"]), want)
    in_place = labelled.copy()
    assert hovernet._remove_small_objects(in_place, 4, out=in_place) is in_place
    np.testing.assert_array_equal(in_place, want)
    np.testing.assert_array_equal(
        hovernet._foreground_labels(x32 / 6 + 0.5, out=sc["i32_b"]), hovernet._foreground_labels(x32 / 6 + 0.5)
    )


def test_pool_reuses_buffers_per_shape_and_thread() -> None:
    np_map, hv_map, _ = many_nuclei_maps()
    HoVerNet._proc_np_hv(np_map, hv_map)
    sc = hovernet._proc_scratch(np_map.shape[:2])
    before = {key: id(buf) for key, buf in sc.bufs.items()}
    assert sc["f64_a"] is sc["f64_a"] and sc["f64_a"].dtype == np.float64 and sc["bool_a"].dtype == np.bool_
    HoVerNet._proc_np_hv(np_map, hv_map)
    assert {key: id(buf) for key, buf in hovernet._SCRATCH.bufs.items()} == before
    other: dict = {}

    def in_another_thread() -> None:
        theirs = hovernet._proc_scratch(np_map.shape[:2])
        other["bufs_before"] = dict(theirs.bufs)
        other["f64_a"] = theirs["f64_a"]

    thread = threading.Thread(target=in_another_thread)
    thread.start()
    thread.join(WAIT_S)
    assert not thread.is_alive()
    assert other["bufs_before"] == {}
    assert other["f64_a"] is not hovernet._SCRATCH["f64_a"]
    assert hovernet._SCRATCH.bufs.keys() == before.keys()  # untouched by the other thread
    fresh = hovernet._proc_scratch((7, 5))
    assert fresh.bufs == {} and fresh["u8_a"].shape == (7, 5)


def test_contiguous_copies_only_a_strided_array() -> None:
    sc = hovernet._proc_scratch((4, 6))
    flat = np.arange(24, dtype=np.float32).reshape(4, 6)
    assert sc.contiguous("f32_x", flat) is flat
    strided = np.arange(48, dtype=np.float32).reshape(4, 6, 2)[..., 1]
    copy = sc.contiguous("f32_x", strided)
    assert copy.flags.c_contiguous and copy is sc.contiguous("f32_x", strided[::-1])
    np.testing.assert_array_equal(copy, strided[::-1])


def test_pool_is_dropped_above_256_mib() -> None:
    assert hovernet._SCRATCH_MAX_RETAIN_BYTES == 256 * 1024 * 1024
    sc = hovernet._proc_scratch((4096, 4096))  # np.empty: the pages are never touched
    sc["f64_a"], sc["f64_b"]  # exactly 256 MiB: kept
    sc.trim()
    assert set(sc.bufs) == {"f64_a", "f64_b"} and sc.shape == (4096, 4096)
    sc["u8_a"]
    sc.trim()
    assert sc.bufs == {} and sc.shape is None
    small = hovernet._proc_scratch((8, 8))
    small["f64_a"]
    small.trim(max_bytes=512)  # 8 * 8 float64
    assert set(small.bufs) == {"f64_a"}
    small.trim(max_bytes=511)
    assert small.bufs == {}


# -- ModelABC's file loaders -------------------------------------------------------------


def test_load_weights_from_file_and_its_static_alias(tmp_path) -> None:
    from tiatoolbox_tpu.models.architecture.weight_converter import save_flax_npz, torch_unet_to_flax
    from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
    from tiatoolbox_tpu_torch.models.models_abc import ModelABC, load_torch_model

    state = UNetModel(3, 2, decoder_block=(3,), seed=21, device="cpu").state_dict()
    torch.save(state, tmp_path / "w.pth")
    save_flax_npz(torch_unet_to_flax({k: v.numpy() for k, v in state.items()}), tmp_path / "w.npz")
    batch = torch.from_numpy(np.random.default_rng(5).random((2, 64, 64, 3), dtype=np.float32))

    def output(load) -> np.ndarray:
        model = UNetModel(3, 2, decoder_block=(3,), seed=99, device="cpu").eval()
        assert load(model) is model
        with torch.inference_mode():
            return model(batch).numpy()

    for name in ("w.pth", "w.npz"):
        want = output(lambda m: load_torch_model(m, tmp_path / name))
        np.testing.assert_array_equal(output(lambda m: m.load_weights_from_file(tmp_path / name)), want)
        np.testing.assert_array_equal(output(lambda m: ModelABC.load_torch_model(m, tmp_path / name)), want)
        np.testing.assert_array_equal(output(lambda m: UNetModel.load_torch_model(m, tmp_path / name)), want)
    fresh = output(lambda m: m)
    assert not np.array_equal(fresh, want)
