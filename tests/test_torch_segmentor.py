"""SemanticSegmentor: the port against the JAX engine, on the CPU, on all three stitch paths.

A synthetic deflate slide written by the port's ``data/synth.py`` (the JAX
reader opens it, checked first) goes through both engines with the same
narrow U-Net (unet encoder, levels 8/16/32, weights from
``test_torch_unet.calibrated_state`` carried over with
``flax_unet_to_torch``). Tolerances: probabilities 1e-4 absolute (float32
convolutions summed in another order; stitching itself is exact), and
predictions equal wherever the top-2 probability margin exceeds 1e-3.

Paths and geometries:
(a) region feed: the bcss geometry scaled down (input 128, output 64,
    stride 48, one resolution), no mask;
(b) per-patch device canvas: a mask removes patches, so no band plan;
(c) host canvas: the device budget is forced below the canvas;
(d) bench config 4's geometry, output resolution half the input's
    (``coord_scale`` 0.5), with the float16 canvas wire (probabilities
    within 1e-4 + 2**-11: each side rounds to float16, and values 1e-4
    apart may round to neighbouring float16 steps);
(e) patch mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_unet import NARROW, calibrated_state, flax_variables
from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.engine.io_config import IOSegmentorConfig as JaxIOSegmentorConfig
from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor
from tiatoolbox_tpu.wsicore.wsireader import WSIReader as JaxWSIReader
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_unet_to_torch
from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, SemanticSegmentor
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


KWARGS = {**NARROW, "num_output_channels": 3}


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("seg") / "slide.tiff"
    make_synthetic_slide(
        path, size=(560, 400), mpp=0.5, objective_power=20, seed=21, compression="deflate"
    )
    return str(path)


@pytest.fixture(scope="module")
def models():
    variables = flax_variables(calibrated_state(KWARGS, seed=22))
    jax_model = JaxUNetModel(**KWARGS)
    jax_model.load_weights(variables)
    port = UNetModel(**KWARGS, device="cpu")
    port.load_state_dict(flax_unet_to_torch(variables))
    return jax_model, port


def _ioconfigs(out_mpp: float, patch_out: int, stride: int):
    kwargs = dict(
        input_resolutions=[{"units": "mpp", "resolution": 0.5}],
        output_resolutions=[{"units": "mpp", "resolution": out_mpp}],
        patch_input_shape=(128, 128),
        patch_output_shape=(patch_out, patch_out),
        stride_shape=(stride, stride),
        save_resolution={"units": "mpp", "resolution": out_mpp},
    )
    return JaxIOSegmentorConfig(**kwargs), IOSegmentorConfig(**kwargs)


def _run(models, slide, ioconfigs, *, masks=None, host_canvas=False, **run_kwargs):
    jax_model, port = models
    jax_seg = JaxSegmentor(jax_model, batch_size=8, num_loader_workers=2, verbose=False)
    port_seg = SemanticSegmentor(port, batch_size=8, num_loader_workers=2, device="cpu", verbose=False)
    if host_canvas:
        jax_seg.DEVICE_CANVAS_MAX_PIXELS = port_seg.DEVICE_CANVAS_MAX_PIXELS = 1
    want = jax_seg.run([slide], masks, patch_mode=False, ioconfig=ioconfigs[0], **run_kwargs)[slide]
    got = port_seg.run([slide], masks, patch_mode=False, ioconfig=ioconfigs[1], **run_kwargs)[str(slide)]
    return want, got, jax_seg.last_stage_summary, port_seg.last_stage_summary


def _assert_same_maps(want: dict, got: dict, atol: float = 1e-4) -> None:
    want_p = np.asarray(want["probabilities"])
    got_p = got["probabilities"]
    assert got_p.dtype == np.float32 and got_p.shape == want_p.shape
    np.testing.assert_allclose(got_p, want_p, atol=atol, rtol=0)
    top2 = np.sort(want_p, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-3
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(got["predictions"][decided], want["predictions"][decided])
    assert got["predictions"].dtype == np.uint8


def test_the_jax_reader_opens_the_port_slide(slide: str) -> None:
    port, ref = WSIReader.open(slide), JaxWSIReader.open(slide)
    assert tuple(ref.info.slide_dimensions) == tuple(port.info.slide_dimensions) == (560, 400)
    assert ref.info.mpp[0] == pytest.approx(0.5)
    np.testing.assert_array_equal(
        ref.read_rect((40, 30), (200, 150)), port.read_rect((40, 30), (200, 150))
    )


def test_region_feed_path_matches_jax(models, slide: str) -> None:
    want, got, jax_stages, port_stages = _run(models, slide, _ioconfigs(0.5, 64, 48), auto_get_mask=False)
    assert port_stages["path"] == jax_stages["path"] == "device-canvas+region-feed"
    for key in ("n_bands", "wire_pixels", "band_wire"):
        assert port_stages[key] == jax_stages[key]
    _assert_same_maps(want, got)
    # every slide pixel is covered: the averaged probabilities sum to 1
    np.testing.assert_allclose(got["probabilities"].sum(-1), 1.0, atol=1e-5)


def test_per_patch_device_canvas_with_a_mask_matches_jax(models, slide: str) -> None:
    mask = np.ones((400, 560), np.uint8)
    mask[:, 300:] = 0
    want, got, jax_stages, port_stages = _run(models, slide, _ioconfigs(0.5, 64, 48), masks=[mask])
    assert port_stages["path"] == jax_stages["path"] == "device-canvas"
    assert port_stages["wire_pixels"] == jax_stages["wire_pixels"]
    _assert_same_maps(want, got)
    assert (got["probabilities"][:, 450:] == 0).all()


def test_host_canvas_path_matches_jax(models, slide: str) -> None:
    want, got, jax_stages, port_stages = _run(
        models, slide, _ioconfigs(0.5, 64, 48), host_canvas=True, auto_get_mask=False
    )
    assert port_stages == jax_stages == {"path": "host-canvas"}
    _assert_same_maps(want, got)


def test_half_resolution_output_geometry_matches_jax(models, slide: str) -> None:
    want, got, jax_stages, port_stages = _run(
        models, slide, _ioconfigs(1.0, 128, 96), auto_get_mask=False, canvas_wire_dtype="float16"
    )
    assert port_stages["path"] == jax_stages["path"] == "device-canvas+region-feed"
    assert got["probabilities"].shape == (200, 280, 3)
    # each side rounds its float32 map to float16 for the wire: two values
    # within 1e-4 may round to neighbouring float16 steps (2**-11 below 1)
    _assert_same_maps(want, got, atol=1e-4 + 2**-11)


def test_patch_mode_matches_jax(models, slide: str) -> None:
    jax_model, port = models
    patches = np.stack([WSIReader.open(slide).read_rect((x, 60), (128, 128)) for x in (0, 100, 250)])
    want = JaxSegmentor(jax_model, batch_size=2, verbose=False).run(patches, patch_mode=True)
    got = SemanticSegmentor(port, batch_size=2, device="cpu", verbose=False).run(patches, patch_mode=True)
    assert got["probabilities"].shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got["probabilities"], np.asarray(want["probabilities"]), atol=1e-4, rtol=0)


def test_what_is_not_ported_raises(models, slide: str, monkeypatch, tmp_path) -> None:
    _, port = models
    seg = SemanticSegmentor(port, batch_size=8, device="cpu", verbose=False)
    ioconfig = _ioconfigs(0.5, 64, 48)[1]
    with pytest.raises(NotImplementedError, match="yuv420"):
        seg.run([slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False, band_wire="yuv420")
    # outputs but "dict" need a save_dir, as in JAX
    with pytest.raises(ValueError, match="output_type"):
        seg.run([slide], patch_mode=False, ioconfig=ioconfig, output_type="zarr", band_wire="rgb")
    with pytest.raises(ValueError, match="save_dir"):
        seg.save_predictions({}, "annotationstore")
    # a host canvas over memory_threshold stays in RAM without a save_dir and
    # spills to save_dir/cache with one (JAX's create_smart_array); the
    # MemoryError the port raised before the spill was ported is gone
    seg.DEVICE_CANVAS_MAX_PIXELS = 1
    monkeypatch.setattr("tiatoolbox_tpu_torch.utils.zarrlite.free_ram_bytes", lambda: 1000)
    in_ram = seg.run([slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False)
    assert seg.last_stage_summary == {"path": "host-canvas"} and seg.spill_bytes == 0
    spilled = seg.run(
        [slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False, save_dir=tmp_path / "out"
    )
    assert seg.spill_bytes > 0
    assert not (tmp_path / "out" / "cache").exists()
    np.testing.assert_array_equal(
        spilled[str(slide)]["probabilities"], in_ram[str(slide)]["probabilities"]
    )
