"""The port's slice end to end against the JAX package, on the CPU.

On a 1024x768 deflate slide both packages plan the same patch grid, mask it
with the same Otsu tissue mask, load the same batches, and classify with
the same resnet18 weights (flax variables carried over with
``flax_resnet_to_torch``). Coordinates and predictions must be identical
and probabilities within 1e-4 (float32 on both sides). The same holds on a
JPEG slide (the port's writer at Q 90), where the port's batch loader
decodes each batch's tiles in one native prefetch. The stain phase runs
the port's plain version beside JAX ``transform_tiles`` over the same
batches, held to one uint8 level and 99.9 % identical values.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.models.architecture.vanilla import CNNModel as JaxCNNModel
from tiatoolbox_tpu.models.dataset import WSIPatchDataset as JaxWSIPatchDataset
from tiatoolbox_tpu.models.engine.io_config import IOPatchPredictorConfig as JaxIOConfig
from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPatchPredictor
from tiatoolbox_tpu.parallel import BatchLoader as JaxBatchLoader
from tiatoolbox_tpu.tools import stainnorm as jax_stainnorm
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_resnet_to_torch
from tiatoolbox_tpu_torch.models.dataset import WSIPatchDataset
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor
from tiatoolbox_tpu_torch.parallel import BatchLoader
from tiatoolbox_tpu_torch.tools import stainnorm as port_stainnorm
from tiatoolbox_tpu_torch.wsicore import tiffio as port_tiffio
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


IOCONFIG = PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"]
GRID = dict(patch_input_shape=(224, 224), stride_shape=(224, 224), resolution=0.5, units="mpp")


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("slice") / "slide.tiff"
    make_synthetic_slide(path, size=(1024, 768), seed=41, compression="deflate")
    return str(path)


@pytest.fixture(scope="module")
def jpeg_slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("slice") / "jpeg_slide.tiff"
    make_synthetic_slide(path, size=(1024, 768), seed=41)
    return str(path)


@pytest.mark.parametrize("auto_get_mask", [True, False])
def test_datasets_and_batches_match_jax(slide: str, auto_get_mask: bool) -> None:
    jax_ds = JaxWSIPatchDataset(slide, auto_get_mask=auto_get_mask, **GRID)
    port_ds = WSIPatchDataset(slide, auto_get_mask=auto_get_mask, **GRID)
    np.testing.assert_array_equal(port_ds.inputs, jax_ds.inputs)
    jax_batches = list(JaxBatchLoader(jax_ds, batch_size=6, num_workers=2))
    port_batches = list(BatchLoader(port_ds, batch_size=6, num_workers=2))
    assert len(port_batches) == len(jax_batches) > 0
    for got, want in zip(port_batches, jax_batches):
        assert got["n_valid"] == want["n_valid"]
        for key in ("image", "coords", "indices"):
            np.testing.assert_array_equal(got[key], want[key])


def test_staged_batches_match_plain_batches(slide: str) -> None:
    dataset = WSIPatchDataset(slide, **GRID)
    plain = list(BatchLoader(dataset, batch_size=4, num_workers=2))
    staged = list(
        BatchLoader(dataset, batch_size=4, num_workers=0).iter_staged(torch.from_numpy)
    )
    assert len(staged) == len(plain)
    for got, want in zip(staged, plain):
        assert isinstance(got["image"], torch.Tensor)
        np.testing.assert_array_equal(got["image"].numpy(), want["image"])
        np.testing.assert_array_equal(got["coords"], want["coords"])


def _predictor_matches_jax(slide: str) -> None:
    jax_model = JaxCNNModel("resnet18", num_classes=9)
    jax_model.init(input_shape=(1, 224, 224, 3))
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(
        lambda leaf: (np.asarray(leaf) + rng.normal(0, 0.05, leaf.shape)).astype(np.float32),
        jax_model.variables,
    )
    jax_model.load_weights(variables)
    port_model = CNNModel("resnet18", num_classes=9, device="cpu")
    port_model.load_state_dict(flax_resnet_to_torch(variables))

    want = JaxPatchPredictor(model=jax_model, batch_size=8, verbose=False).run(
        [slide], patch_mode=False, ioconfig=JaxIOConfig(**IOCONFIG)
    )[slide]
    got = PatchPredictor(model=port_model, batch_size=8, verbose=False, device="cpu").run(
        [slide], patch_mode=False, ioconfig=IOPatchPredictorConfig(**IOCONFIG)
    )[slide]
    np.testing.assert_array_equal(got["coordinates"], want["coordinates"])
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=1e-4, rtol=0)

    patches = np.stack([WSIPatchDataset(slide, **GRID)[i]["image"] for i in range(3)])
    patch_out = PatchPredictor(model=port_model, batch_size=2, verbose=False, device="cpu").run(
        patches, patch_mode=True
    )
    np.testing.assert_allclose(
        patch_out["probabilities"], got["probabilities"][:3], atol=1e-6, rtol=0
    )


def test_patch_predictor_wsi_matches_jax(slide: str) -> None:
    _predictor_matches_jax(slide)


def test_patch_predictor_jpeg_slide_matches_jax(jpeg_slide: str) -> None:
    """Phase B on a JPEG slide; the port's batches read tiles its prefetch
    decoded in native batches."""
    port_tiffio.reset_decode_counts()
    _predictor_matches_jax(jpeg_slide)
    assert port_tiffio.decode_counts["batch"] > 0
    jax_ds = JaxWSIPatchDataset(jpeg_slide, **GRID)
    port_ds = WSIPatchDataset(jpeg_slide, **GRID)
    for i in (0, len(port_ds) // 2, len(port_ds) - 1):
        np.testing.assert_array_equal(port_ds[i]["image"], jax_ds[i]["image"])


def test_stain_phase_matches_jax(slide: str) -> None:
    target = synthetic_he_patch((128, 128), seed=42)
    thumb = WSIReader.open(slide).slide_thumbnail()
    jax_norm = jax_stainnorm.get_normalizer("macenko")
    port_norm = port_stainnorm.get_normalizer("macenko")
    jax_norm.fit(target)
    port_norm.fit(target)
    jax_c = jax_norm.prepare_tile_transform(thumb)
    port_c = port_norm.prepare_tile_transform(thumb)
    dataset = WSIPatchDataset(slide, auto_get_mask=False, **GRID)
    for batch in BatchLoader(dataset, batch_size=8, num_workers=2):
        want = np.asarray(jax_norm.transform_tiles(batch["image"], jax_c))
        got = port_norm.transform_tiles(batch["image"], port_c, device="cpu").numpy()
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1
        assert np.mean(diff == 0) >= 0.999
