"""The port's pretrained registry against the JAX package's, and the IDaRS path.

``PRETRAINED_MODELS`` must hold every one of the JAX registry's 74 entries
(``tiatoolbox_tpu/data/pretrained_model.yaml``, read through the JAX
package), each equal to JAX's: architecture class and kwargs, dataset and
ioconfig. Every one of the 51 ``vanilla.CNNModel`` entries builds on the
CPU with its backbone's feature width and its class count (a forward at the
registry's input shape for the small backbones only), and so does each of
the 11 entries of KongNet, the tissue masks and NuClick. ``idars_preproc`` must equal JAX's bit for
bit, and an idars entry's float patches run through the port's engine as
through JAX's (probabilities within 1e-4, float32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu import _get_pretrained_info
from tiatoolbox_tpu.models.architecture.idars import idars_preproc as jax_idars_preproc
from tiatoolbox_tpu.models.architecture.vanilla import CNNModel as JaxCNNModel
from tiatoolbox_tpu.models.dataset.classification import predefined_preproc_func as jax_preproc_func
from tiatoolbox_tpu.models.engine.patch_predictor import PatchPredictor as JaxPatchPredictor
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
from tiatoolbox_tpu_torch.models.architecture.idars import IDaRS, idars_preproc
from tiatoolbox_tpu_torch.models.architecture.vanilla import _FEATURE_WIDTHS, CNNModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_resnet_to_torch
from tiatoolbox_tpu_torch.models.dataset.classification import predefined_preproc_func
from tiatoolbox_tpu_torch.models.engine import IOPatchPredictorConfig, PatchPredictor

CLASSIFIERS = sorted(k for k, v in PRETRAINED_MODELS.items() if v["architecture"]["class"] == "vanilla.CNNModel")
# a forward at the registry's input shape costs little for these on the CPU
SMALL = ("alexnet", "googlenet", "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "resnet18")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_registry() -> dict:
    return _get_pretrained_info()


def test_every_classifier_of_the_jax_registry_is_served(jax_registry) -> None:
    """All 74 entries of the JAX yaml are served, the 51 classifiers among them."""
    jax_classifiers = sorted(k for k, v in jax_registry.items() if v["architecture"]["class"] == "vanilla.CNNModel")
    assert CLASSIFIERS == jax_classifiers and len(CLASSIFIERS) == 51
    assert sorted(PRETRAINED_MODELS) == sorted(jax_registry) and len(PRETRAINED_MODELS) == 74


@pytest.mark.parametrize("name", sorted(PRETRAINED_MODELS))
def test_entry_equals_the_jax_registry(name: str, jax_registry) -> None:
    want = jax_registry[name]
    got = PRETRAINED_MODELS[name]
    for key in ("architecture", "dataset", "ioconfig"):
        assert got.get(key) == want.get(key), key


@pytest.mark.parametrize("name", CLASSIFIERS)
def test_classifier_entry_builds_on_the_cpu(name: str) -> None:
    cfg = PRETRAINED_MODELS[name]
    kwargs = cfg["architecture"]["kwargs"]
    model, ioconfig = get_pretrained_model(name, device="cpu")
    assert isinstance(model, CNNModel) and model.device.type == "cpu"
    assert model.classifier.in_features == _FEATURE_WIDTHS[kwargs["backbone"]]
    assert model.classifier.out_features == kwargs["num_classes"]
    assert list(ioconfig.patch_input_shape) == cfg["ioconfig"]["kwargs"]["patch_input_shape"]
    dataset = cfg["dataset"]
    assert model.preproc_func is predefined_preproc_func(dataset)
    if kwargs["backbone"] in SMALL:
        h, w = ioconfig.patch_input_shape
        patch = np.random.default_rng(0).integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        batch = np.stack([model.preproc_func(p) for p in patch])
        probs = CNNModel.infer_batch(model, batch)
        assert probs.shape == (1, kwargs["num_classes"])
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)


# the entries served since the tissue masks, KongNet and NuClick were ported
REGISTRY_TAIL = {
    **{
        name: ("KongNet", "IOSegmentorConfig")
        for name in (
            "KongNet_CoNIC_1", "KongNet_Det_MIDOG_1", "KongNet_MONKEY_1", "KongNet_PUMA_T1_3",
            "KongNet_PUMA_T2_3", "KongNet_PanNuke_1",
        )
    },
    "efficientunet-tissue_mask": ("EfficientUNetTissueMaskModel", "IOSegmentorConfig"),
    "grandqc_tissue_detection": ("GrandQCModel", "IOSegmentorConfig"),
    "nuclick_light-pannuke": ("UNetModel", "IOSegmentorConfig"),
    "nuclick_original-pannuke": ("NuClick", "IOSegmentorConfig"),
    "unet_tissue_mask_tsef": ("UNetModel", "IOSegmentorConfig"),
}


@pytest.mark.parametrize("name", sorted(REGISTRY_TAIL))
def test_registry_tail_entry_builds_on_the_cpu(name: str) -> None:
    """Each entry builds on the CPU as its class with its registry kwargs, and
    its ioconfig with the registry's shapes, resolutions and units."""
    cls, io_cls = REGISTRY_TAIL[name]
    cfg = PRETRAINED_MODELS[name]
    model, ioconfig = get_pretrained_model(name, device="cpu")
    assert type(model).__name__ == cls and model.device.type == "cpu"
    assert type(ioconfig).__name__ == io_cls
    io_kwargs = cfg["ioconfig"]["kwargs"]
    assert list(ioconfig.patch_input_shape) == io_kwargs["patch_input_shape"]
    assert list(ioconfig.patch_output_shape) == io_kwargs["patch_output_shape"]
    assert list(ioconfig.stride_shape) == io_kwargs.get("stride_shape", io_kwargs["patch_input_shape"])
    assert ioconfig.highest_input_resolution == io_kwargs["input_resolutions"][0]
    kwargs = cfg["architecture"]["kwargs"]
    if cls == "KongNet":
        assert len(model.heads) == kwargs["num_heads"] and model.target_channels == kwargs["target_channels"]
        assert model.decoders[0].blocks[4].conv2[0].out_channels == (32 if kwargs["wide_decoder"] else 16)
        assert model.class_dict == kwargs["class_dict"] and len(model.class_dict) == len(kwargs["target_channels"])
        assert model.encoder.model.variant == "efficientnetv2_l"
    elif cls == "UNetModel":
        assert model.num_input_channels == kwargs["num_input_channels"]
        assert model.clf.out_channels == kwargs["num_output_channels"]


def test_idars_preproc_equals_jax_bit_for_bit() -> None:
    patch = np.random.default_rng(1).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    got = idars_preproc(patch)
    want = jax_idars_preproc(patch)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(predefined_preproc_func("idars")(patch), jax_preproc_func("idars")(patch))
    assert IDaRS.preproc is not CNNModel.preproc
    np.testing.assert_array_equal(IDaRS.preproc(patch), want)
    with pytest.raises(ValueError, match="does not exist"):
        predefined_preproc_func("camelyon")


def test_idars_float_patches_through_the_engine_match_jax() -> None:
    """``resnet18-idars-msi``: the host preproc gives float32 patches, which
    ``apply_u8`` takes as model-ready (no second /255), in both packages."""
    jax_model = JaxCNNModel("resnet18", num_classes=2)
    shapes = jax.eval_shape(lambda: jax_model.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(2)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    jax_model.load_weights(variables)
    jax_model.preproc_func = jax_preproc_func("idars")
    port, _ = get_pretrained_model("resnet18-idars-msi", device="cpu")
    port.load_state_dict(flax_resnet_to_torch(variables))
    assert port.preproc_func is idars_preproc

    patches = np.random.default_rng(3).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    want = JaxPatchPredictor(model=jax_model, batch_size=2, verbose=False).run(patches, patch_mode=True)
    got = PatchPredictor(model=port, batch_size=2, verbose=False, device="cpu").run(patches, patch_mode=True)
    np.testing.assert_allclose(got["probabilities"], np.asarray(want["probabilities"]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    with torch.inference_mode():
        direct = port(torch.from_numpy(np.stack([idars_preproc(p) for p in patches])))
    np.testing.assert_allclose(got["probabilities"], torch.softmax(direct, -1).numpy(), atol=1e-6, rtol=0)


def test_registry_ioconfigs_build() -> None:
    for name in CLASSIFIERS:
        IOPatchPredictorConfig(**PRETRAINED_MODELS[name]["ioconfig"]["kwargs"])
