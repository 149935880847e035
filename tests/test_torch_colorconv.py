"""The yuv420 wire and the colour conversions: the port against the JAX package, on the CPU.

- The host pack (``rgb_batch_to_yuv420``, ``rgb_image_to_yuv420``) is
  JAX's cv2 pack byte for byte: all 2^24 colours, and a ragged band that is
  edge-padded.
- The unpack's plain version (what K8 computes; ``yuv420_batch_to_rgb`` and
  ``unpack_yuv420_band`` run it on a CPU tensor) is JAX's XLA program bit
  for bit in float32, with and without ``apply_u8``'s ``/ 255``, over every
  (Cb, Cr) pair under 32 seeded luma values, and for the band. A bfloat16
  unpack is within 2^-7 of JAX's: JAX rounds each operation to bfloat16,
  the port once at the end, and values in [0.5, 1) step by 2^-8.
- ``rgb2grey`` bit for bit on all colours; ``rgb2od`` within 1e-6
  relative; ``od2rgb`` within one level, and equal on 99.9 % of seeded
  densities (each truncates its own float32 ``exp``).
- ``apply_u8`` on packed planes against JAX's (resnet18 at 32^2, float32,
  1e-5), ``PatchPredictor`` with ``wire_format="yuv420"`` against JAX's
  (1e-3, the classifier's tolerance) with its patch-mode store extents, and
  ``SemanticSegmentor`` with ``band_wire="yuv420"`` against JAX's (the
  narrow U-Net, 1e-4 as ``test_torch_segmentor.py``), its "pack" stage
  present and its wire bytes half the RGB run's.
"""

from __future__ import annotations

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_segmentor import KWARGS as UNET_KWARGS
from test_torch_segmentor import _ioconfigs
from test_torch_unet import calibrated_state, flax_variables
from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.architecture.vanilla import CNNModel as JaxCNNModel
from tiatoolbox_tpu.models.architecture.weight_converter import torch_resnet_to_flax
from tiatoolbox_tpu.models.engine.io_config import IOPatchPredictorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPatchPredictor
from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor
from tiatoolbox_tpu.ops import colorconv as jax_cc
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_unet_to_torch
from tiatoolbox_tpu_torch.models.engine import SemanticSegmentor
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor
from tiatoolbox_tpu_torch.ops import colorconv

BF16_TOL = 2.0**-7


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def all_colours() -> np.ndarray:
    """Every uint8 RGB colour once, as a 4096x4096 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


def every_chroma_pair(seed: int = 0) -> np.ndarray:
    """Planes ``[8, 192, 2048]``: each image's chroma planes hold all 65,536
    (Cb, Cr) pairs, its luma is seeded, so each pair meets 8 x 4 = 32 luma values."""
    rng = np.random.default_rng(seed)
    h, w = 128, 2048
    pairs = np.arange(1 << 16)
    planes = np.empty((8, h + h // 2, w), np.uint8)
    planes[:, :h] = rng.integers(0, 256, (8, h, w))
    planes[:, h : h + h // 4] = (pairs & 255).astype(np.uint8).reshape(h // 4, w)
    planes[:, h + h // 4 :] = (pairs >> 8).astype(np.uint8).reshape(h // 4, w)
    return planes


def test_pack_is_jax_cv2_pack_on_every_colour() -> None:
    image = all_colours()
    want = jax_cc.rgb_batch_to_yuv420(image[None])
    got = colorconv.rgb_batch_to_yuv420(image[None])
    assert got.dtype == np.uint8 and got.shape == (1, 6144, 4096)
    np.testing.assert_array_equal(got, want)
    out = np.empty_like(want)
    assert colorconv.rgb_batch_to_yuv420(image[None], out=out) is out


@pytest.mark.parametrize("size_wh", [(113, 70), (114, 72), (64, 64)])
def test_band_pack_pads_as_jax(size_wh) -> None:
    image = synthetic_he_patch(size_wh, seed=3)
    want = jax_cc.rgb_image_to_yuv420(image)
    got = colorconv.rgb_image_to_yuv420(image)
    h, w = image.shape[0] + (-image.shape[0]) % 4, image.shape[1] + (-image.shape[1]) % 2
    assert got.shape == (h * 3 // 2, w)
    np.testing.assert_array_equal(got, want)


def test_pack_refuses_odd_shapes() -> None:
    with pytest.raises(ValueError, match="yuv420"):
        colorconv.rgb_batch_to_yuv420(np.zeros((1, 30, 30, 3), np.uint8))
    with pytest.raises(ValueError, match="yuv420"):
        colorconv.yuv420_batch_to_rgb(torch.zeros((1, 44, 30), dtype=torch.uint8))


@pytest.mark.parametrize("scale", [False, True], ids=["rgb", "div255"])
def test_batch_unpack_is_jax_bit_for_bit(scale: bool) -> None:
    planes = every_chroma_pair()
    if scale:  # apply_u8's _run_yuv
        want = jax.jit(lambda x: jax_cc.yuv420_batch_to_rgb(x) / 255.0)(jnp.asarray(planes))
    else:
        want = jax.jit(jax_cc.yuv420_batch_to_rgb)(jnp.asarray(planes))
    got = colorconv.yuv420_batch_to_rgb(torch.from_numpy(planes), scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 128, 2048, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_unpack_within_its_tolerance() -> None:
    planes = every_chroma_pair(seed=1)
    want = jax.jit(lambda x: jax_cc.yuv420_batch_to_rgb(x, dtype=jnp.bfloat16) / 255.0)(jnp.asarray(planes))
    got = colorconv.yuv420_batch_to_rgb(torch.from_numpy(planes), torch.bfloat16, scale=True)
    assert got.dtype == torch.bfloat16
    # the port rounds its float32 result once: the float32 unpack cast to bfloat16
    exact = colorconv.yuv420_batch_to_rgb(torch.from_numpy(planes), scale=True)
    assert torch.equal(got, exact.to(torch.bfloat16))
    assert np.abs(got.float().numpy() - np.asarray(want).astype(np.float32)).max() <= BF16_TOL


@pytest.mark.parametrize("band_hw", [(128, 2048), (125, 2047), (70, 113)])
def test_band_unpack_is_jax_bit_for_bit(band_hw) -> None:
    planes = every_chroma_pair(seed=2)[0]
    if band_hw == (70, 113):  # a ragged band through the band pack
        planes = colorconv.rgb_image_to_yuv420(synthetic_he_patch((113, 70), seed=3))
    want = np.asarray(jax_cc.unpack_yuv420_band(jnp.asarray(planes), band_hw))
    got = colorconv.unpack_yuv420_band(torch.from_numpy(planes), band_hw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (*band_hw, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rgb2grey_rgb2od_od2rgb_match_jax() -> None:
    image = all_colours()
    for rows in np.array_split(np.arange(4096), 4):
        part = image[rows]
        np.testing.assert_array_equal(
            colorconv.rgb2grey(torch.from_numpy(part)).numpy(), np.asarray(jax_cc.rgb2grey(jnp.asarray(part)))
        )
    part = image[:256]
    od = colorconv.rgb2od(torch.from_numpy(part))
    want_od = np.asarray(jax_cc.rgb2od(jnp.asarray(part)))
    np.testing.assert_allclose(od.numpy(), want_od, rtol=1e-6, atol=0)
    # the round trip lands within a rounding of each integer level, where the
    # two frameworks' float32 exp may truncate to neighbouring levels
    back = colorconv.od2rgb(od).numpy().astype(int)
    assert np.abs(back - part.astype(int)).max() <= 1
    od = np.random.default_rng(5).uniform(0.0, 4.0, (1 << 20,)).astype(np.float32)
    got = colorconv.od2rgb(torch.from_numpy(od)).numpy().astype(int)
    want = np.asarray(jax_cc.od2rgb(jnp.asarray(od))).astype(int)
    assert np.abs(got - want).max() <= 1
    assert (got == want).mean() >= 0.999


# -- the wire through the models and engines ---------------------------------------


def resnet_pair():
    """The port's seeded resnet18 (4 classes; the classifier scaled so the
    softmax does not saturate) and JAX's with its weights, carried over by
    JAX's converter (no flax initialisation: it takes seconds on a CPU)."""
    port = CNNModel("resnet18", num_classes=4, device="cpu")
    with torch.no_grad():
        port.classifier.weight.mul_(0.02)
    jax_model = JaxCNNModel("resnet18", num_classes=4)
    jax_model.load_weights(torch_resnet_to_flax({k: v.numpy() for k, v in port.state_dict().items()}))
    return jax_model, port


@pytest.fixture(name="resnet_pair", scope="module")
def _resnet_pair():
    return resnet_pair()


def test_apply_u8_on_planes_matches_jax(resnet_pair) -> None:
    jax_model, port = resnet_pair
    batch = np.random.default_rng(3).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    planes = colorconv.rgb_batch_to_yuv420(batch)
    want = np.asarray(jax_model.apply_u8(jnp.asarray(planes)))  # JAX's module ends in its softmax
    got = torch.softmax(port.apply_u8(torch.from_numpy(planes)), dim=-1).numpy()
    assert 0.05 < want.max() < 0.95
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # stage_batch packs a 4-D uint8 host batch on the yuv420 wire, and only then
    port.wire_format = "yuv420"
    try:
        staged = port.stage_batch(batch)
        np.testing.assert_array_equal(staged.numpy(), planes)
        band = batch[0]
        assert port.stage_batch(band).shape == band.shape
    finally:
        port.wire_format = "rgb"


@pytest.fixture(scope="module")
def small_slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("wire") / "slide.tiff"
    make_synthetic_slide(path, size=(512, 384), mpp=0.5, seed=5, compression="deflate")
    return str(path)


PREDICT_IOCONFIG = dict(input_resolutions=[{"units": "mpp", "resolution": 2.0}], patch_input_shape=(32, 32))


def test_patch_predictor_on_the_yuv_wire_matches_jax(resnet_pair, small_slide: str, tmp_path) -> None:
    jax_model, port = resnet_pair
    jax_model.wire_format = port.wire_format = "yuv420"
    try:
        want = JaxPatchPredictor(jax_model, batch_size=8, num_loader_workers=0, verbose=False).run(
            [small_slide], patch_mode=False, ioconfig=JaxIOConfig(**PREDICT_IOCONFIG), auto_get_mask=False
        )[small_slide]
        predictor = PatchPredictor(port, batch_size=8, num_loader_workers=2, device="cpu", verbose=False)
        got = predictor.run(
            [small_slide], patch_mode=False, ioconfig=IOPatchPredictorConfig(**PREDICT_IOCONFIG),
            auto_get_mask=False,
        )[small_slide]
        # 128x96 at 2 mpp: a 4x3 grid of 32^2 patches, 12 bytes of planes for every 24 of RGB
        assert got["probabilities"].shape == (12, 4)
        np.testing.assert_array_equal(got["coordinates"], want["coordinates"])
        np.testing.assert_allclose(got["probabilities"], np.asarray(want["probabilities"]), atol=1e-3, rtol=0)
        stages = predictor.stages
        assert stages["pack"]["items"] == 2 * stages["wire"]["items"] == 2 * 8 * 48 * 32 * 2
        # patch mode: the store's boxes are the patches' own 32x32 extents, not the planes'
        patches = np.random.default_rng(4).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
        path = PatchPredictor(port, batch_size=4, num_loader_workers=0, device="cpu", verbose=False).run(
            patches, patch_mode=True, output_type="annotationstore", save_dir=tmp_path / "yuv"
        )
        with sqlite3.connect(path) as con:
            rows = con.execute("SELECT max_x - min_x, max_y - min_y FROM rtree").fetchall()
        assert len(rows) == 6 and all((w, h) == (32, 32) for w, h in rows)
    finally:
        jax_model.wire_format = port.wire_format = "rgb"


@pytest.fixture(scope="module")
def unet_pair():
    variables = flax_variables(calibrated_state(UNET_KWARGS, seed=22))
    jax_model = JaxUNetModel(**UNET_KWARGS)
    jax_model.load_weights(variables)
    port = UNetModel(**UNET_KWARGS, device="cpu")
    port.load_state_dict(flax_unet_to_torch(variables))
    return jax_model, port


def test_semantic_segmentor_yuv_band_wire_matches_jax(unet_pair, tmp_path) -> None:
    jax_model, port = unet_pair
    slide = str(make_synthetic_slide(
        tmp_path / "slide.tiff", size=(560, 400), mpp=0.5, objective_power=20, seed=21, compression="deflate"
    ))
    ioconfig = _ioconfigs(0.5, 64, 48)
    run = dict(patch_mode=False, auto_get_mask=False)
    want = JaxSegmentor(jax_model, batch_size=8, num_loader_workers=0, verbose=False).run(
        [slide], ioconfig=ioconfig[0], band_wire="yuv420", **run
    )[slide]
    results = {}
    for wire in ("yuv420", "rgb"):
        seg = SemanticSegmentor(port, batch_size=8, device="cpu", verbose=False)
        results[wire] = (seg.run([slide], ioconfig=ioconfig[1], band_wire=wire, **run)[slide], seg.last_stage_summary)
    got, summary = results["yuv420"]
    rgb, rgb_summary = results["rgb"]
    assert summary["path"] == "device-canvas+region-feed" and summary["band_wire"] == "yuv420"
    assert "pack" in summary and "pack" not in rgb_summary
    # a band of h x w pixels ships 1.5 h' w bytes against 3 h w (h' = h padded to 4 rows)
    assert 0.5 <= summary["wire"]["items"] / rgb_summary["wire"]["items"] <= 0.52
    np.testing.assert_allclose(got["probabilities"], np.asarray(want["probabilities"]), atol=1e-4, rtol=0)
    delta = np.abs(got["probabilities"] - rgb["probabilities"])
    assert 0 < delta.max() < 0.05  # the wire is lossy in chroma, a few levels a pixel
