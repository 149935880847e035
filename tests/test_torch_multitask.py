"""MultiTaskSegmentor: the port against the JAX engine on the CPU, slide to instances.

A synthetic 560x400 slide like that of ``tests/engines/test_multihead_canvas.py``
(0.25 mpp, 40x, not a multiple of the 164-pixel stride, so edge cells
overrun the canvas; 12 patches where the 700x500 slide there has 20, which
keeps this file near a minute on one CPU worker), written by the port's
``data/synth.py``, goes through both engines
with the functional HoVer-Net checkpoint (``hovernet_fast-pannuke``'s
network, 6 types): the JAX model with the bench script's variables, the
port's with ``functional_hovernet_state_dict``. Each model keeps its own
outputs per patch, so a patch that several runs share is forwarded once
per framework (the forward costs seconds a patch on a CPU; it is compared
on its own in ``tests/test_torch_hovernet.py``).

Paths: (a) the region feed with full-canvas post-processing (the packed
uint8 plane and the energy: K4, K2, K6, K3, K5 through their plain
versions); (b) the per-patch feed (``[np, energy, tp]``); (c) tile mode
(``full_postproc_limit`` below the canvas, 256-pixel tiles, the 4-pass
merge); (d) the host canvas; (e) patch mode.

Instances are matched by centroid. Tolerance: the same number of
instances, every centroid matched within 0.5 pixel, and box, contour and
type equal for every matched pair. The forwards differ by about 1e-6
(float32 convolutions summed in another order), which could move a pixel
across the 0.5 foreground threshold; on this slide none does.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hovernet import _ShapeOnlyModel
from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
from tiatoolbox_tpu.models.engine.io_config import IOInstanceSegmentorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.multi_task_segmentor import MultiTaskSegmentor as JaxSegmentor
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import functional_hovernet_state_dict
from tiatoolbox_tpu_torch.models.engine import IOInstanceSegmentorConfig, MultiTaskSegmentor

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

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


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    """Four intra-op threads for this module (the port's full-width forward
    on the CPU is its cost); the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _key(patch: np.ndarray) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(patch).tobytes()).digest()


class _PortOnce(HoVerNet):
    """The port's HoVerNet, forwarding each distinct patch once."""

    @classmethod
    def infer_batch_device(cls, model, batch_data, device=None):
        x = model.stage_batch(batch_data)
        keys = [_key(p) for p in x.numpy()]
        missing = sorted({k: i for i, k in enumerate(keys) if k not in model.memo}.values())
        if missing:
            heads = super().infer_batch_device(model, x[missing], device)
            for j, i in enumerate(missing):
                model.memo[keys[i]] = [h[j] for h in heads]
        return tuple(torch.stack([model.memo[k][h] for k in keys]) for h in range(3))


class _JaxOnce(JaxHoVerNet):
    """The JAX HoVerNet, forwarding each distinct patch once."""

    @staticmethod
    def infer_batch_device(model, batch_data, device=None):
        x = np.asarray(batch_data)
        keys = [_key(p) for p in x]
        missing = sorted({k: i for i, k in enumerate(keys) if k not in model.memo}.values())
        if missing:
            heads = JaxHoVerNet.infer_batch_device(model, x[missing], device)
            for j, i in enumerate(missing):
                model.memo[keys[i]] = [np.asarray(h[j]) for h in heads]
        return tuple(jnp.asarray(np.stack([model.memo[k][h] for k in keys])) for h in range(3))


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("mts") / "slide.tiff"
    make_synthetic_slide(
        path, size=(560, 400), mpp=0.25, objective_power=40, compression="deflate"
    )
    return str(path)


@pytest.fixture(scope="module")
def models():
    from make_bench_checkpoints import build_functional_hovernet_variables

    jax_model = _JaxOnce(num_types=6, mode="fast")
    jax_model.memo = {}
    port_state = functional_hovernet_state_dict()
    jax_model.load_weights(build_functional_hovernet_variables(_ShapeOnlyModel(6, "fast")))
    port = _PortOnce(num_types=6, mode="fast", device="cpu")
    port.memo = {}
    port.load_state_dict(port_state)
    return jax_model, port


def _run_both(models, slide, *, jax_setup=None, port_setup=None, **run_kwargs):
    jax_model, port = models
    jax_seg = JaxSegmentor(jax_model, batch_size=4, num_loader_workers=0, verbose=False)
    port_seg = MultiTaskSegmentor(port, batch_size=4, num_loader_workers=0, verbose=False, device="cpu")
    for seg, setup in ((jax_seg, jax_setup), (port_seg, port_setup)):
        if setup is not None:
            setup(seg)
    want = jax_seg.run([slide], patch_mode=False, ioconfig=JaxIOConfig(**IOCONFIG), auto_get_mask=False, **run_kwargs)
    got = port_seg.run(
        [slide], patch_mode=False, ioconfig=IOInstanceSegmentorConfig(**IOCONFIG), auto_get_mask=False, **run_kwargs
    )
    return got[slide], want[slide], port_seg, jax_seg


def _assert_instances_match(got: dict, want: dict) -> int:
    """Same count; each centroid matched within 0.5 px; box, contour and type equal."""
    got_list, want_list = list(got.values()), list(want.values())
    assert len(got_list) == len(want_list)
    want_cents = np.array([np.asarray(v["centroid"], float) for v in want_list])
    for inst in got_list:
        dist = np.abs(want_cents - np.asarray(inst["centroid"], float)).max(axis=1)
        j = int(np.argmin(dist))
        assert dist[j] <= 0.5
        ref = want_list[j]
        np.testing.assert_array_equal(inst["box"], ref["box"])
        np.testing.assert_array_equal(inst["contours"], ref["contours"])
        assert inst["type"] == ref["type"]
    return len(got_list)


def test_region_feed_matches_jax(models, slide) -> None:
    got, want, port_seg, jax_seg = _run_both(models, slide)
    assert port_seg.last_stage_summary["path"] == jax_seg.last_stage_summary["path"]
    assert port_seg.last_stage_summary["path"] == "multitask-device-canvas+region-feed+banded-u8+device-energy"
    assert _assert_instances_match(got["instances"], want["instances"]) > 20
    assert {"watershed", "instance_info", "instance-postproc", "fetch"} <= set(port_seg.last_stage_summary)


def test_per_patch_feed_matches_jax(models, slide) -> None:
    got, want, port_seg, jax_seg = _run_both(models, slide, region_feed=False)
    assert port_seg.last_stage_summary["path"] == "multitask-device-canvas+device-energy"
    assert jax_seg.last_stage_summary["path"] == "multitask-device-canvas+device-energy"
    assert _assert_instances_match(got["instances"], want["instances"]) > 20


def test_tile_mode_matches_jax(models, slide) -> None:
    def tiles(seg) -> None:
        seg.full_postproc_limit = 100_000
        seg.tile_shape = (256, 256)

    got, want, port_seg, _ = _run_both(models, slide, jax_setup=tiles, port_setup=tiles)
    assert port_seg.last_stage_summary["path"] == "multitask-device-canvas+region-feed"
    assert _assert_instances_match(got["instances"], want["instances"]) > 20


def test_host_canvas_matches_jax(models, slide) -> None:
    def host(seg) -> None:
        seg._can_use_multihead_device_canvas = lambda *a, **k: False

    got, want, port_seg, _ = _run_both(models, slide, jax_setup=host, port_setup=host, return_predictions=True)
    assert port_seg.last_stage_summary["path"] == "multitask-host-stitch"
    _assert_instances_match(got["instances"], want["instances"])
    np_map, hv_map, tp_map = got["predictions"]
    np.testing.assert_allclose(np_map, want["predictions"][0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(hv_map, want["predictions"][1], rtol=0, atol=1e-4)
    # outside the nuclei the five non-background type logits are equal up to
    # the checkpoint's 1e-3 noise, so the argmax there follows summation order
    assert float((tp_map == want["predictions"][2]).mean()) >= 0.98


def test_patch_mode_matches_jax(models) -> None:
    from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch

    jax_model, port = models
    patches = np.stack([synthetic_he_patch((256, 256), seed=3)])
    want = JaxSegmentor(jax_model, batch_size=2, num_loader_workers=0, verbose=False).run(
        patches, patch_mode=True
    )
    got = MultiTaskSegmentor(port, batch_size=2, num_loader_workers=0, verbose=False, device="cpu").run(
        patches, patch_mode=True
    )
    assert len(got["instances"]) == 1
    assert _assert_instances_match(got["instances"][0], want["instances"][0]) > 3


def test_postproc_func_gets_the_raw_maps_as_in_jax(models, slide) -> None:
    """A caller's ``postproc_func`` takes the engine off the packed fetch: it
    gets the raw ``[np, hv, tp]`` maps of the whole canvas, as JAX's engine
    gives them, and its results become the instances."""
    seen: dict = {}

    def recording(name):
        def setup(seg) -> None:
            model = seg.model

            def postproc(maps):
                seen[name] = [np.asarray(m) for m in maps]
                return model.postproc(seen[name])

            model.postproc_func = postproc

        return setup

    try:
        got, want, port_seg, _ = _run_both(
            models, slide, jax_setup=recording("jax"), port_setup=recording("port")
        )
    finally:
        for model in models:
            model.postproc_func = None
    assert port_seg.last_stage_summary["path"] == "multitask-device-canvas+region-feed"
    assert [m.shape for m in seen["port"]] == [m.shape for m in seen["jax"]]
    assert [m.shape[-1] for m in seen["port"]] == [1, 2, 1]
    (np_map, hv_map, tp_map), want_maps = seen["port"], seen["jax"]
    np.testing.assert_allclose(np_map, want_maps[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(hv_map, want_maps[1], rtol=0, atol=1e-4)
    # the type argmax outside the nuclei follows summation order, as in
    # test_host_canvas_matches_jax
    assert float((tp_map == want_maps[2]).mean()) >= 0.98
    assert _assert_instances_match(got["instances"], want["instances"]) > 20


def test_outputs_other_than_dict_raise(models) -> None:
    # without a save_dir, and for patch mode's per-patch instances, as in JAX
    seg = MultiTaskSegmentor(models[1], device="cpu", verbose=False)
    with pytest.raises(ValueError, match="save_dir"):
        seg.save_predictions({"instances": {}}, "annotationstore")
    with pytest.raises(ValueError, match="Patch-mode"):
        seg.save_predictions({"instances": [{}]}, "zarr", save_dir=".")


def _instance_rows(instances: dict) -> list:
    """Instances by content: contour, box, type and prob, sorted (keys are uuid4)."""
    return sorted(
        (np.asarray(v["contours"]).tolist(), np.asarray(v["box"]).tolist(), v["type"], float(v["prob"]))
        for v in instances.values()
    )


@pytest.mark.parametrize("kind", ["zarr", "annotationstore", "qupath"])
def test_engine_outputs_match_jax(models, slide, tmp_path, kind: str) -> None:
    """``run(output_type=...)`` writes JAX's file name, with JAX's instances."""
    import json

    from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore
    from tiatoolbox_tpu_torch.utils.zarrlite import open_zarr

    jax_model, port = models
    common = dict(patch_mode=False, auto_get_mask=False, output_type=kind)
    want = JaxSegmentor(jax_model, batch_size=4, num_loader_workers=0, verbose=False).run(
        [slide], ioconfig=JaxIOConfig(**IOCONFIG), save_dir=tmp_path / "jax", **common
    )[slide]
    got = MultiTaskSegmentor(port, batch_size=4, num_loader_workers=0, verbose=False, device="cpu").run(
        [slide], ioconfig=IOInstanceSegmentorConfig(**IOCONFIG), save_dir=tmp_path / "port", **common
    )[slide]
    suffix = {"zarr": ".zarr", "annotationstore": ".db", "qupath": ".json"}[kind]
    assert got == tmp_path / "port" / f"slide{suffix}"
    assert Path(want).name == got.name
    if kind == "zarr":
        g, w = open_zarr(got).attrs["instances"], open_zarr(want).attrs["instances"]
        rows_g, rows_w = _instance_rows(g), _instance_rows(w)
    elif kind == "annotationstore":
        def rows(path):
            return sorted(
                (a.geometry.to_wkb(), a.properties["type"], a.properties["prob"]) for a in SQLiteStore(path).values()
            )

        rows_g, rows_w = rows(got), rows(want)
    else:
        def rows(path):
            feats = json.loads(Path(path).read_text())["features"]
            return sorted(
                (json.dumps(f["geometry"]), f["properties"]["classification"]["name"], f["properties"]["prob"])
                for f in feats
            )

        rows_g, rows_w = rows(got), rows(want)
    assert len(rows_g) == len(rows_w) > 20
    for g_row, w_row in zip(rows_g, rows_w):
        assert g_row[:-1] == w_row[:-1]
        assert g_row[-1] == pytest.approx(w_row[-1], abs=1e-5)


@pytest.mark.parametrize("tile_mode", [False, True])
def test_host_canvas_spill_equals_ram(models, slide, tmp_path, tile_mode: bool) -> None:
    """With a ``save_dir`` and ``memory_threshold=0`` the host canvases go to
    zarr under ``save_dir/cache``; the instances equal the in-RAM run's (tile
    mode reads the zarr canvases tile by tile), and the cache is removed."""
    _, port = models
    seg = MultiTaskSegmentor(port, batch_size=4, num_loader_workers=0, verbose=False, device="cpu")
    seg._can_use_multihead_device_canvas = lambda *a, **k: False
    if tile_mode:
        seg.full_postproc_limit = 100_000
        seg.tile_shape = (256, 256)
    common = dict(patch_mode=False, ioconfig=IOInstanceSegmentorConfig(**IOCONFIG), auto_get_mask=False)
    ram = seg.run([slide], memory_threshold=1.0, **common)[slide]
    assert seg.spill_bytes == 0
    spilled = seg.run([slide], memory_threshold=0.0, save_dir=tmp_path / "out", **common)[slide]
    assert seg.last_stage_summary["path"] == "multitask-host-stitch" and seg.spill_bytes > 0
    assert not (tmp_path / "out" / "cache").exists()
    assert _instance_rows(spilled["instances"]) == _instance_rows(ram["instances"])
    assert len(ram["instances"]) > 20
