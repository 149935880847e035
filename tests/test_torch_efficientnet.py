"""EfficientNet encoders and classifier: the port against the flax modules on the CPU.

Random flax variables of the shapes ``jax.eval_shape`` gives go through
``flax_efficientnet_to_torch`` (timm's names) into the port, and the same
seeded float batch runs through both in float32. Kernels are drawn with
variance 1/fan_in: with He's 2/fan_in, 40 random MBConv blocks of
EfficientNetV2-S amplify float32 rounding by about 5x a block (measured: the
two frameworks' stage outputs part at the seventh block of stage 3 with
either backend's summation order), a property of such weights and not of
the port. Tolerance: each stage output within 1e-4 of its largest |value|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture import efficientnet as jax_efficientnet
from tiatoolbox_tpu.models.architecture.vit import TimmBackbone as JaxTimmBackbone
from tiatoolbox_tpu_torch.models.architecture import efficientnet
from tiatoolbox_tpu_torch.models.architecture.vit import TimmBackbone
from tiatoolbox_tpu_torch.models.architecture.weight_converter import (
    flax_efficientnet_to_torch,
    flax_timm_to_torch,
)

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(module, size: int, seed: int) -> dict:
    """Seeded random flax variables of ``module`` at a ``size``^2 input."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0, np.sqrt(1.0 / np.prod(shape[:-1])), shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def _pair(flax_module, port_module, size: int, seed: int):
    variables = random_variables(flax_module, size, seed)
    port_module.load_state_dict(flax_efficientnet_to_torch(variables), strict=True)
    return variables, port_module.eval()


@pytest.mark.parametrize("padding", ["SAME", "symmetric"])
@pytest.mark.parametrize("size", [64, 65])
def test_b0_encoder_stage_features_match_flax(padding: str, size: int) -> None:
    """The five stage outputs (strides 2-32) in both padding modes; 65^2 gives
    the even "SAME" pads that 64^2's uneven ones do not."""
    flax = jax_efficientnet.EfficientNetEncoder(conv_padding=padding)
    variables, port = _pair(flax, efficientnet.EfficientNetEncoder(conv_padding=padding), 64, seed=1)
    x = np.random.default_rng(2).random((2, size, size, 3), dtype=np.float32)
    want = jax.jit(flax.apply)(variables, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w)
    assert [g.shape[-1] for g in got] == efficientnet.EFFICIENTNET_STAGE_CHANNELS["efficientnet_b0"]


def test_v2_encoder_matches_flax() -> None:
    flax = jax_efficientnet.EfficientNetV2Encoder(variant="efficientnetv2_s")
    variables, port = _pair(flax, efficientnet.EfficientNetV2Encoder("efficientnetv2_s"), 64, seed=3)
    x = np.random.default_rng(4).random((2, 64, 64, 3), dtype=np.float32)
    want = jax.jit(flax.apply)(variables, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert [g.shape[1] for g in got] == [32, 16, 8, 4, 2]
    for g, w in zip(got, want):
        _close(g, w)


def test_classifier_without_head_matches_flax() -> None:
    flax = jax_efficientnet.EfficientNetClassifier(num_classes=0)
    variables, port = _pair(flax, efficientnet.EfficientNetClassifier(num_classes=0), 64, seed=5)
    x = np.random.default_rng(6).random((2, 64, 64, 3), dtype=np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got, jax.jit(flax.apply)(variables, x))
    assert got.shape == (2, 1280)


def test_classifier_with_head_matches_flax() -> None:
    flax = jax_efficientnet.EfficientNetClassifier(variant="efficientnet_b1", num_classes=7)
    variables, port = _pair(flax, efficientnet.EfficientNetClassifier("efficientnet_b1", num_classes=7), 64, seed=7)
    x = np.random.default_rng(8).random((2, 64, 64, 3), dtype=np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got, jax.jit(flax.apply)(variables, x))


def test_timm_backbone_efficientnet_matches_flax() -> None:
    """``TimmBackbone("efficientnet_b0")``: uint8 /255, the pooled head features."""
    jax_model = JaxTimmBackbone("efficientnet_b0")
    variables = random_variables(jax_model.module, 64, seed=9)
    jax_model.load_weights(variables)
    port = TimmBackbone("efficientnet_b0", device="cpu")
    port.load_state_dict(flax_timm_to_torch(variables, classifier=False), strict=True)
    batch = np.random.default_rng(10).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    got = TimmBackbone.infer_batch(port, batch)
    want = np.asarray(JaxTimmBackbone.infer_batch(jax_model, batch))
    assert got.shape == want.shape == (2, 1280)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize(
    "variant", [*(f"efficientnet_b{i}" for i in range(2, 8)), "efficientnetv2_m", "efficientnetv2_l"]
)
def test_converter_names_and_shapes_load_strictly(variant: str) -> None:
    """Every flax leaf of the deeper members lands on a timm-named port
    tensor of its shape, and none of the port's is left out."""
    if variant.startswith("efficientnetv2"):
        flax, port = jax_efficientnet.EfficientNetV2Encoder(variant=variant), efficientnet.EfficientNetV2Encoder(variant)
    else:
        flax, port = jax_efficientnet.EfficientNetClassifier(variant=variant), efficientnet.EfficientNetClassifier(variant)
    shapes = jax.eval_shape(lambda: flax.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = flax_efficientnet_to_torch(variables)
    want = port.state_dict()
    assert set(state) == set(want)
    for key, value in state.items():
        assert value.shape == want[key].shape, key
    port.load_state_dict(state, strict=True)


def test_timm_names_and_tables() -> None:
    state = efficientnet.EfficientNetClassifier(num_classes=3).state_dict()
    for key in (
        "conv_stem.weight",
        "bn1.running_var",
        "blocks.0.0.conv_dw.weight",
        "blocks.0.0.se.conv_reduce.bias",
        "blocks.0.0.conv_pw.weight",
        "blocks.1.0.conv_pw.weight",
        "blocks.1.0.conv_pwl.weight",
        "blocks.6.0.bn3.weight",
        "conv_head.weight",
        "bn2.bias",
        "classifier.weight",
    ):
        assert key in state, key
    v2 = efficientnet.EfficientNetV2Encoder("efficientnetv2_s").state_dict()
    for key in ("blocks.0.1.conv.weight", "blocks.0.1.bn1.weight", "blocks.1.0.conv_exp.weight",
                "blocks.2.3.conv_pwl.weight", "blocks.5.14.se.conv_expand.weight"):
        assert key in v2, key
    assert efficientnet.EFFICIENTNET_STAGE_CHANNELS == jax_efficientnet.EFFICIENTNET_STAGE_CHANNELS
    assert efficientnet.EFFICIENTNETV2_CONFIGS == jax_efficientnet.EFFICIENTNETV2_CONFIGS
    assert efficientnet.EFFICIENTNET_PARAMS == jax_efficientnet.EFFICIENTNET_PARAMS
    bn_eps = {m.eps for m in efficientnet.EfficientNetEncoder().modules() if isinstance(m, torch.nn.BatchNorm2d)}
    assert bn_eps == {1e-3}
