"""The tissue-mask models: GrandQC, EfficientUNet and ``unet_tissue_mask_tsef``
against the JAX package on the CPU.

Weights are drawn for the port's ``state_dict`` (``torch_seeded.seeded_state``),
carried to flax by JAX's ``torch_grandqc_to_flax`` / ``torch_efficientunet_to_flax``
and back by the port's ``flax_*_to_torch``, which must give the same
``state_dict`` (EfficientUNet's unused ``_conv_head``/``_bn1``, which JAX's
converter skips, come back as zeros and an identity batch norm). The same
patches then go through both ``preproc``, ``infer_batch`` and ``postproc``:
probabilities within 1e-4, logits within 1e-4 of their largest magnitude,
postprocs bit for bit where the probabilities are decided. GrandQC's JPEG-80
preproc and EfficientUNet's elliptical close/open must equal OpenCV's bit
for bit (odd sizes, 512^2, masks touching the border, batched and single).
Each model runs through ``SemanticSegmentor`` on a small synthetic slide
against JAX's engine; the tsef U-Net geometry (a quarter-size output, 4x
overlap, baseline units) runs on the region feed with a narrow U-Net.
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from torch_seeded import assert_same_state, seeded_state
from test_torch_unet import calibrated_state, flax_variables
from tiatoolbox_tpu.models.architecture.efficientunet_tissue_mask_model import (
    EfficientUNetTissueMaskModel as JaxEfficientUNet,
)
from tiatoolbox_tpu.models.architecture.grandqc import GrandQCModel as JaxGrandQC
from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.architecture.weight_converter import (
    torch_efficientunet_to_flax,
    torch_grandqc_to_flax,
)
from tiatoolbox_tpu.models.engine.io_config import IOSegmentorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture import load_weights
from tiatoolbox_tpu_torch.models.architecture.efficientunet_tissue_mask_model import (
    EfficientUNetTissueMaskModel,
    morphology_close,
    morphology_open,
)
from tiatoolbox_tpu_torch.models.architecture.grandqc import GrandQCModel, jpeg_roundtrip
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import (
    flax_efficientunet_to_torch,
    flax_grandqc_to_torch,
    flax_unet_to_torch,
)
from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, SemanticSegmentor

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import make_grandqc_golden as golden  # noqa: E402

PROB_TOL = 1e-4
LOGIT_TOL = 1e-4
UNUSED_HEAD = ("encoder._conv_head.", "encoder._bn1.")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def grandqc_pair():
    port = GrandQCModel(class_dict={0: "Background", 1: "Tissue"}, device="cpu")
    state = seeded_state(port, 1)
    port.load_state_dict(state, strict=True)
    variables = torch_grandqc_to_flax({k: v.numpy() for k, v in state.items()})
    assert_same_state(flax_grandqc_to_torch(variables), state)
    jax_model = JaxGrandQC()
    jax_model.load_weights(variables)
    return jax_model, port


@pytest.fixture(scope="module")
def effunet_pair():
    port = EfficientUNetTissueMaskModel(device="cpu")
    state = seeded_state(port, 2)
    port.load_state_dict(state, strict=True)
    variables = torch_efficientunet_to_flax({k: v.numpy() for k, v in state.items()})
    back = flax_efficientunet_to_torch(variables)
    assert_same_state(
        {k: v for k, v in back.items() if not k.startswith(UNUSED_HEAD)},
        {k: v for k, v in state.items() if not k.startswith(UNUSED_HEAD)},
    )
    assert torch.equal(back["encoder._conv_head.weight"], torch.zeros(1280, 320, 1, 1))
    jax_model = JaxEfficientUNet()
    jax_model.load_weights(variables)
    return jax_model, port


def _patches(n: int, size: int, seed: int) -> np.ndarray:
    return np.stack([synthetic_he_patch((size, size), seed=seed + i) for i in range(n)])


def _assert_model_matches(jax_model, port, patches: np.ndarray):
    """Both ``preproc`` bit for bit, ``infer_batch`` and the forward logits."""
    batch = np.stack([type(port).preproc(p) for p in patches])
    np.testing.assert_array_equal(batch, np.stack([type(jax_model).preproc(p) for p in patches]))
    want = np.asarray(type(jax_model).infer_batch(jax_model, batch))
    got = type(port).infer_batch(port, batch)
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= PROB_TOL
    import jax

    want_logits = np.asarray(jax.jit(jax_model.module.apply)(jax_model.variables, batch))
    with torch.inference_mode():
        got_logits = port(torch.from_numpy(batch)).numpy()
    assert float(np.abs(got_logits - want_logits).max()) <= LOGIT_TOL * float(np.abs(want_logits).max())
    return got, want


@pytest.mark.parametrize("size", [64, 96])
def test_grandqc_matches_flax(grandqc_pair, size: int) -> None:
    jax_model, port = grandqc_pair
    got, want = _assert_model_matches(jax_model, port, _patches(2, size, seed=3))
    decided = np.abs(want[..., 0] - want[..., 1]) > 1e-3
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(GrandQCModel.postproc(got)[decided], JaxGrandQC.postproc(want)[decided])


@pytest.mark.parametrize("size", [64, 96])
def test_efficientunet_matches_flax(effunet_pair, size: int) -> None:
    jax_model, port = effunet_pair
    got, want = _assert_model_matches(jax_model, port, _patches(2, size, seed=5))
    # postproc: threshold at the median, so the mask has both classes
    port.threshold = jax_model.threshold = float(np.median(want))
    decided = np.abs(want[..., 0] - port.threshold) > 1e-3
    np.testing.assert_array_equal(port.postproc(want), jax_model.postproc(want))
    assert (port.postproc(got) == jax_model.postproc(want)).mean() > 0.99 or decided.all()


def test_upstream_names() -> None:
    effunet = EfficientUNetTissueMaskModel(device="cpu").state_dict()
    for key in (
        "encoder._conv_stem.weight",
        "encoder._bn0.running_mean",
        "encoder._blocks.0._depthwise_conv.weight",
        "encoder._blocks.0._se_reduce.bias",
        "encoder._blocks.1._expand_conv.weight",
        "encoder._blocks.15._bn2.weight",
        "encoder._conv_head.weight",
        "encoder._bn1.running_var",
        "decoder.blocks.0.conv1.0.weight",
        "decoder.blocks.4.conv2.1.bias",
        "segmentation_head.0.bias",
    ):
        assert key in effunet, key
    assert not any(k.startswith("encoder._blocks.0._expand_conv") for k in effunet)
    assert effunet["decoder.blocks.0.conv1.0.weight"].shape == (256, 320 + 112, 3, 3)
    grandqc = GrandQCModel(device="cpu").state_dict()
    for key in (
        "encoder.conv_stem.weight",
        "encoder.blocks.0.0.conv_dw.weight",
        "encoder.blocks.0.0.conv_pw.weight",
        "encoder.blocks.6.0.bn3.running_var",
        "decoder.blocks.x_0_0.conv1.0.weight",
        "decoder.blocks.x_2_3.conv2.1.weight",
        "decoder.blocks.x_0_4.conv1.0.weight",
        "segmentation_head.0.weight",
    ):
        assert key in grandqc, key
    assert sum(k.endswith("conv1.0.weight") and k.startswith("decoder.") for k in grandqc) == 11
    bn_eps = {m.eps for m in GrandQCModel(device="cpu").encoder.modules() if isinstance(m, torch.nn.BatchNorm2d)}
    assert bn_eps == {1e-5}


def test_wrapped_checkpoints_load(grandqc_pair, effunet_pair, tmp_path) -> None:
    """``.pth`` files in each wrapper of ``unwrap_checkpoint``; GrandQC's with the
    timm encoder head an upstream checkpoint may hold, which no forward uses."""
    _, port = grandqc_pair
    state = dict(port.state_dict())
    extra = {"encoder.conv_head.weight": torch.zeros(1280, 320, 1, 1), "encoder.bn2.weight": torch.ones(1280)}
    for i, wrapped in enumerate(({"state_dict": {**state, **extra}}, {"desc": {"model": state}}, {"model": state})):
        torch.save(wrapped, tmp_path / f"g{i}.pth")
        fresh = GrandQCModel(seed=7 + i, device="cpu")
        load_weights(fresh, tmp_path / f"g{i}.pth")
        assert_same_state(fresh.state_dict(), state)
    _, port = effunet_pair
    torch.save({"state_dict": port.state_dict()}, tmp_path / "e.pth")
    fresh = EfficientUNetTissueMaskModel(seed=9, device="cpu")
    load_weights(fresh, tmp_path / "e.pth")
    assert_same_state(fresh.state_dict(), port.state_dict())


def _jax_preproc_u8(image: np.ndarray) -> np.ndarray:
    """What JAX's GrandQC preproc hands to the normalisation: cv2's round trip."""
    stream = cv2.imencode(".jpg", image, [int(cv2.IMWRITE_JPEG_QUALITY), 80])[1]
    return cv2.imdecode(stream, 1)


@pytest.mark.parametrize("shape", [(1, 1), (17, 33), (67, 45), (255, 129), (512, 512)])
def test_grandqc_jpeg_preproc_equals_cv2_bit_for_bit(shape) -> None:
    for image in (
        synthetic_he_patch(shape, seed=sum(shape)),
        np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8),
    ):
        np.testing.assert_array_equal(jpeg_roundtrip(image), _jax_preproc_u8(image))
        got, want = GrandQCModel.preproc(image), JaxGrandQC.preproc(image)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_grandqc_golden_file_is_what_the_script_writes() -> None:
    committed = np.load(golden.DEFAULT_OUT)
    fresh = golden.build()
    assert set(committed.files) == set(fresh)
    for key, value in fresh.items():
        if key != "cv2_version":
            np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert golden.DEFAULT_OUT.stat().st_size < 100_000
    assert chip_smoke.check_grandqc_golden() == {"cases": len(golden.CASES)}


def _blobs(shape, seed: int, *, border: bool) -> np.ndarray:
    """A 0/1 uint8 mask of smooth blobs with gaps and holes; with ``border``,
    blobs and thin strips on every edge."""
    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.random(shape), 10)
    mask = (field > np.quantile(field, 0.6)).astype(np.uint8)
    mask[rng.random(shape) > 0.995] ^= 1
    if border:
        mask[:9, : shape[1] // 3] = 1
        mask[-2:, shape[1] // 2 :] = 1
        mask[shape[0] // 3 : shape[0] // 2, :5] = 1
        mask[:, -1] = 1
        mask[5:7, 5:60] = 0
    return mask


@pytest.mark.parametrize("border", [False, True])
@pytest.mark.parametrize("shape", [(97, 131), (300, 257), (48, 70)])
def test_ellipse_close_open_equal_cv2_bit_for_bit(shape, border: bool) -> None:
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (31, 31))
    mixed = 0
    for seed in range(3):
        mask = _blobs(shape, seed, border=border)
        closed = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
        opened = cv2.morphologyEx(closed, cv2.MORPH_OPEN, kernel)
        np.testing.assert_array_equal(morphology_close(mask), closed)
        opened_raw = cv2.morphologyEx(mask, cv2.MORPH_OPEN, kernel)
        np.testing.assert_array_equal(morphology_open(mask), opened_raw)
        np.testing.assert_array_equal(morphology_open(closed), opened)
        mixed += sum(0 < m.mean() < 1 for m in (closed, opened, opened_raw))
    assert mixed  # some result keeps both classes
    for ksize in (3, 7, 15):
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
        mask = _blobs(shape, 9, border=border)
        np.testing.assert_array_equal(morphology_close(mask, ksize), cv2.morphologyEx(mask, cv2.MORPH_CLOSE, k))


def test_efficientunet_postproc_batched_and_single_equal_jax() -> None:
    jax_model = JaxEfficientUNet()
    port = EfficientUNetTissueMaskModel(device="cpu")
    rng = np.random.default_rng(11)
    probs = np.stack([ndimage.gaussian_filter(rng.random((150, 170)), 5) for _ in range(3)])[..., None]
    probs = ((probs - probs.min()) / (probs.max() - probs.min())).astype(np.float32)
    for threshold in (0.95, 0.6, 0.45):
        port.threshold = jax_model.threshold = threshold
        batched = port.postproc(probs)
        np.testing.assert_array_equal(batched, jax_model.postproc(probs))
        assert batched.shape == (3, 150, 170) and batched.dtype == np.uint8
        np.testing.assert_array_equal(port.postproc(probs[1]), jax_model.postproc(probs[1]))
        np.testing.assert_array_equal(port.postproc(probs[1]), batched[1])


@pytest.fixture(scope="module")
def low_res_slide(tmp_path_factory) -> str:
    """A 600x448 slide declared at 4 mpp: 240x179 at 10 mpp, 300x224 at 8 mpp."""
    path = tmp_path_factory.mktemp("tissue") / "tissue.tiff"
    make_synthetic_slide(path, size=(600, 448), mpp=4.0, objective_power=2.5, seed=13, compression="deflate")
    return str(path)


def _engines_run(jax_model, port, slide: str, name: str, patch: int, stride: int):
    kwargs = dict(PRETRAINED_MODELS[name]["ioconfig"]["kwargs"])
    kwargs.update(patch_input_shape=[patch, patch], patch_output_shape=[patch, patch], stride_shape=[stride, stride])
    jax_seg = JaxSegmentor(jax_model, batch_size=4, num_loader_workers=0, verbose=False)
    port_seg = SemanticSegmentor(port, batch_size=4, num_loader_workers=0, device="cpu", verbose=False)
    common = dict(patch_mode=False, auto_get_mask=False)
    want = jax_seg.run([slide], ioconfig=JaxIOConfig(**kwargs), **common)[slide]
    got = port_seg.run([slide], ioconfig=IOSegmentorConfig(**kwargs), **common)[slide]
    assert port_seg.last_stage_summary["path"] == "device-canvas"  # the host preproc: per patch
    want_p = np.asarray(want["probabilities"])
    assert got["probabilities"].shape == want_p.shape
    assert float(np.abs(got["probabilities"] - want_p).max()) <= PROB_TOL
    return got["probabilities"], want_p


def test_grandqc_engine_matches_jax(grandqc_pair, low_res_slide: str) -> None:
    got, want = _engines_run(*grandqc_pair, low_res_slide, "grandqc_tissue_detection", 64, 48)
    assert got.shape == (179, 240, 2)
    decided = np.abs(want[..., 0] - want[..., 1]) > 1e-3
    np.testing.assert_array_equal(GrandQCModel.postproc(got)[decided], JaxGrandQC.postproc(want)[decided])


def test_efficientunet_engine_matches_jax(effunet_pair, low_res_slide: str) -> None:
    jax_model, port = effunet_pair
    got, want = _engines_run(jax_model, port, low_res_slide, "efficientunet-tissue_mask", 64, 60)
    assert got.shape == (224, 300, 1)
    port.threshold = jax_model.threshold = float(np.median(want))
    np.testing.assert_array_equal(port.postproc(want), jax_model.postproc(want))


TSEF_NARROW = dict(num_input_channels=3, num_output_channels=3, encoder="unet", encoder_levels=(8, 16, 32))


def test_tsef_geometry_region_feed_matches_jax(tmp_path) -> None:
    """``unet_tissue_mask_tsef``'s geometry, scaled by 1/16: patches four times
    the stride, outputs half the patch (4x overlap on each canvas pixel),
    baseline units; a narrow U-Net on the region feed, against JAX."""
    slide = str(make_synthetic_slide(tmp_path / "tsef.tiff", size=(200, 152), mpp=0.5, seed=14, compression="deflate"))
    variables = flax_variables(calibrated_state(TSEF_NARROW, seed=15))
    jax_model = JaxUNetModel(**TSEF_NARROW)
    jax_model.load_weights(variables)
    port = UNetModel(**TSEF_NARROW, device="cpu")
    port.load_state_dict(flax_unet_to_torch(variables))
    kwargs = dict(PRETRAINED_MODELS["unet_tissue_mask_tsef"]["ioconfig"]["kwargs"])
    kwargs.update(patch_input_shape=[64, 64], patch_output_shape=[32, 32], stride_shape=[16, 16])
    jax_seg = JaxSegmentor(jax_model, batch_size=8, num_loader_workers=0, verbose=False)
    port_seg = SemanticSegmentor(port, batch_size=8, num_loader_workers=0, device="cpu", verbose=False)
    want = jax_seg.run([slide], patch_mode=False, ioconfig=JaxIOConfig(**kwargs), auto_get_mask=False)[slide]
    got = port_seg.run([slide], patch_mode=False, ioconfig=IOSegmentorConfig(**kwargs), auto_get_mask=False)[slide]
    assert port_seg.last_stage_summary["path"] == jax_seg.last_stage_summary["path"] == "device-canvas+region-feed"
    want_p = np.asarray(want["probabilities"])
    assert got["probabilities"].shape == want_p.shape == (152, 200, 3)
    np.testing.assert_allclose(got["probabilities"], want_p, atol=PROB_TOL, rtol=0)
