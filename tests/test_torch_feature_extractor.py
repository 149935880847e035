"""DeepFeatureExtractor: the port's engine against the JAX engine on the CPU.

The same random flax variables of a resnet18 ``CNNBackbone`` (carried over
with ``flax_cnn_backbone_to_torch``) run through both engines on the same
patches and over the same 1024x768 deflate slide (the port's writer; both
packages plan the same Otsu-masked 224^2 grid at 0.5 mpp). Coordinates must
be equal and features within 1e-4 of the largest |feature| (float32). The
zarr group either package writes must open in the other with the same
arrays, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture.vanilla import CNNBackbone as JaxCNNBackbone
from tiatoolbox_tpu.models.engine.deep_feature_extractor import DeepFeatureExtractor as JaxExtractor
from tiatoolbox_tpu.models.engine.io_config import IOPatchPredictorConfig as JaxIOConfig
from tiatoolbox_tpu.utils.zarrlite import open_zarr as jax_open_zarr
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_cnn_backbone_to_torch
from tiatoolbox_tpu_torch.models.engine import DeepFeatureExtractor, IOPatchPredictorConfig
from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup, open_zarr

TOL = 1e-4
IOCONFIG = PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("features") / "slide.tiff"
    make_synthetic_slide(path, size=(1024, 768), seed=43, compression="deflate")
    return str(path)


@pytest.fixture(scope="module")
def models():
    """(JAX CNNBackbone, port CNNBackbone) with the same random resnet18 weights."""
    jax_model = JaxCNNBackbone("resnet18")
    shapes = jax.eval_shape(lambda: jax_model.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    jax_model.load_weights(variables)
    port = CNNBackbone("resnet18", device="cpu")
    port.load_state_dict(flax_cnn_backbone_to_torch(variables, "resnet18"))
    return jax_model, port


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_patch_mode_matches_jax(models) -> None:
    jax_model, port = models
    patches = np.random.default_rng(4).integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    labels = np.arange(5)
    want = JaxExtractor(model=jax_model, batch_size=2, verbose=False).run(
        patches, labels=labels, patch_mode=True, return_labels=True
    )
    got = DeepFeatureExtractor(model=port, batch_size=2, verbose=False, device="cpu").run(
        patches, labels=labels, patch_mode=True, return_labels=True
    )
    assert set(got) == set(want) == {"features", "labels"}
    _close(got["features"], np.asarray(want["features"]))
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["features"].shape == (5, 512)


@pytest.fixture(scope="module")
def slide_outputs(models, slide, tmp_path_factory):
    """Both engines over the slide: (port dict, JAX dict, port zarr, JAX zarr)."""
    jax_model, port = models
    out = tmp_path_factory.mktemp("feature_outputs")
    want = JaxExtractor(model=jax_model, batch_size=4, verbose=False).run(
        [slide], patch_mode=False, ioconfig=JaxIOConfig(**IOCONFIG)
    )[slide]
    engine = DeepFeatureExtractor(model=port, batch_size=4, verbose=False, device="cpu")
    got = engine.run([slide], patch_mode=False, ioconfig=IOPatchPredictorConfig(**IOCONFIG))[slide]
    port_zarr = engine.run(
        [slide], patch_mode=False, ioconfig=IOPatchPredictorConfig(**IOCONFIG), save_dir=out / "port",
        output_type="zarr",
    )[slide]
    jax_zarr = JaxExtractor(model=jax_model, batch_size=4, verbose=False).run(
        [slide], patch_mode=False, ioconfig=JaxIOConfig(**IOCONFIG), save_dir=out / "jax", output_type="zarr"
    )[slide]
    return got, want, port_zarr, jax_zarr


def test_wsi_mode_matches_jax(slide_outputs) -> None:
    got, want, _, _ = slide_outputs
    assert set(got) == set(want) == {"features", "coordinates"}
    np.testing.assert_array_equal(got["coordinates"], want["coordinates"])
    assert len(got["coordinates"]) > 4
    _close(got["features"], np.asarray(want["features"]))


def test_zarr_written_by_either_package_opens_in_the_other(slide_outputs) -> None:
    got, want, port_zarr, jax_zarr = slide_outputs
    assert port_zarr.name == jax_zarr.name == "slide.zarr"
    by_jax = jax_open_zarr(port_zarr)
    by_port = open_zarr(jax_zarr)
    assert set(by_jax.keys()) == set(open_zarr(port_zarr).keys()) == {"features", "coordinates"}
    assert set(by_port.keys()) == {"features", "coordinates"}
    np.testing.assert_array_equal(by_jax["features"][:], got["features"])
    np.testing.assert_array_equal(by_jax["coordinates"][:], got["coordinates"])
    np.testing.assert_array_equal(by_port["coordinates"][:], got["coordinates"])
    np.testing.assert_array_equal(by_port["features"][:], np.asarray(want["features"]))


def test_outputs_and_refused_types(models, tmp_path) -> None:
    _, port = models
    engine = DeepFeatureExtractor(model=port, batch_size=2, verbose=False, device="cpu")
    patches = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    as_dict = engine.run(patches, patch_mode=True, output_type="dict")
    assert set(as_dict) == {"features"} and as_dict["features"].shape == (3, 512)
    with pytest.raises(ValueError, match="Unsupported output_type"):
        engine.save_predictions(as_dict, "annotationstore", tmp_path)
    with pytest.raises(ValueError, match="save_dir"):
        engine.save_predictions(as_dict, "zarr")
    written = engine.save_predictions({**as_dict, "labels": np.arange(3)}, "zarr", tmp_path, output_file="f.zarr")
    group = open_zarr(written)
    assert isinstance(group, ZarrGroup) and set(group.keys()) == {"features", "labels"}
    np.testing.assert_array_equal(group["features"][:], as_dict["features"])
