"""The patch-classifier zoo: the port's non-ResNet backbones against the flax models.

Random flax variables (He-normal kernels, batch-norm scales and variances in
[0.5, 1.5], shifts and means of 0.1) of the shapes ``jax.eval_shape`` gives
go through ``flax_cnn_backbone_to_torch`` into the port's ``CNNModel`` and
``CNNBackbone``, and the same seeded uint8 batch runs through both packages
in float32 on the CPU. Tolerances: softmax probabilities 1e-4 absolute,
pooled features 1e-4 of the largest |feature| (float32 convolutions summed
in another order by XLA and by PyTorch's CPU kernels). The shallowest
member of each family runs forward at 64^2 (inception_v3 at 96^2, the
smallest size its VALID stem and reductions take); the odd size 65^2
exercises XLA's "SAME" padding at every stride-2 site (MobileNet stems and
strided depthwise convs, GoogLeNet's 7x7/2 stem and max-pools) on the
other parity of sizes than 64^2 does. The other
members get converter tests: names, shapes and a strict ``load_state_dict``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture import cnn_backbones as jax_backbones
from tiatoolbox_tpu.models.architecture.vanilla import CNNBackbone as JaxCNNBackbone
from tiatoolbox_tpu.models.architecture.vanilla import CNNModel as JaxCNNModel
from tiatoolbox_tpu_torch.models.architecture import cnn_backbones
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone, CNNModel, get_backbone
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_cnn_backbone_to_torch

TOL = 1e-4
FORWARD = {  # the shallowest member of each family, at its test size
    "alexnet": 64,
    "densenet121": 64,
    "mobilenet_v2": 64,
    "mobilenet_v3_small": 64,
    "mobilenet_v3_large": 64,
    "googlenet": 64,
    "inception_v3": 96,
}
SAME_STRIDE_2 = ("mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large", "googlenet")
CONVERTED_ONLY = ("densenet161", "densenet169", "densenet201")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_variables(shapes, seed: int, gain: float = 2.0) -> dict:
    """Seeded random flax variables of the given shapes (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, np.sqrt(gain / fan_in), shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_PAIRS: dict = {}


def classifier_pair(backbone: str):
    """(JAX CNNModel, its variables, the port's CNNModel with them), built once."""
    if backbone not in _PAIRS:
        size = FORWARD.get(backbone, 64)
        jax_model = JaxCNNModel(backbone, num_classes=5)
        shapes = jax.eval_shape(
            lambda: jax_model.module.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
        )
        variables = random_variables(shapes, seed=len(backbone))
        jax_model.load_weights(variables)
        port = CNNModel(backbone, num_classes=5, device="cpu")
        port.load_state_dict(flax_cnn_backbone_to_torch(variables, backbone))
        _PAIRS[backbone] = (jax_model, variables, port)
    return _PAIRS[backbone]


def _batch(size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (2, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("backbone", list(FORWARD))
def test_softmax_matches_flax(backbone: str) -> None:
    jax_model, _, port = classifier_pair(backbone)
    batch = _batch(FORWARD[backbone], seed=1)
    got = CNNModel.infer_batch(port, batch)
    want = np.asarray(JaxCNNModel.infer_batch(jax_model, batch))
    assert got.shape == want.shape == (2, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("backbone", list(FORWARD))
def test_features_match_flax(backbone: str) -> None:
    """``CNNBackbone``: the flax ``CNNBackbone``'s pooled features."""
    _, variables, _ = classifier_pair(backbone)
    trunk = {kind: {"backbone": tree["backbone"]} for kind, tree in variables.items()}
    jax_model = JaxCNNBackbone(backbone)
    jax_model.load_weights(trunk)
    port = CNNBackbone(backbone, device="cpu")
    port.load_state_dict(flax_cnn_backbone_to_torch(trunk, backbone))
    batch = _batch(FORWARD[backbone], seed=2)
    got = CNNBackbone.infer_batch(port, batch)
    want = np.asarray(JaxCNNBackbone.infer_batch(jax_model, batch))
    assert got.shape == want.shape == (2, get_backbone(backbone)[1])
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("backbone", SAME_STRIDE_2)
def test_odd_input_size_matches_flax_same_padding(backbone: str) -> None:
    """The backbone's feature map at 65^2. XLA's stride-2 "SAME" pads follow
    the input size: uneven (0 before, 1 after a 3x3) on the even sizes of the
    tests above, even on both sides down an odd chain, uneven again at
    GoogLeNet's 2x2 max-pool on 5^2; torchvision pads the same on both sides
    at every size."""
    _, variables, port = classifier_pair(backbone)
    batch = _batch(65, seed=3)
    with torch.inference_mode():
        got_feat = port.feat_extract(torch.from_numpy(batch).float() / 255.0).numpy()
    trunk = {kind: tree["backbone"] for kind, tree in variables.items()}
    cls, cfg, _ = jax_backbones.EXTRA_BACKBONES[backbone]
    flax = cls(**cfg)
    want_feat = np.asarray(jax.jit(flax.apply)(trunk, batch.astype(np.float32) / 255.0))
    assert got_feat.shape == want_feat.shape
    assert np.abs(got_feat - want_feat).max() <= TOL * np.abs(want_feat).max()


def test_same_pads_follow_xla() -> None:
    """``same_pads`` against ``jax.lax.padtype_to_pads`` over sizes, kernels and strides."""
    for size in range(1, 40):
        for kernel in (1, 2, 3, 5, 7):
            for stride in (1, 2, 3):
                want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
                assert cnn_backbones.same_pads(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("backbone", [*FORWARD, *CONVERTED_ONLY])
def test_converter_names_and_shapes_load_strictly(backbone: str) -> None:
    """Every flax leaf lands on a port parameter or buffer of its shape, and
    the port's ``state_dict`` has no key the converter leaves out."""
    if backbone in FORWARD:
        _, variables, _ = classifier_pair(backbone)
    else:
        jax_model = JaxCNNModel(backbone, num_classes=5)
        shapes = jax.eval_shape(
            lambda: jax_model.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        )
        variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = flax_cnn_backbone_to_torch(variables, backbone)
    port = CNNModel(backbone, num_classes=5, device="cpu")
    want = port.state_dict()
    assert set(state) == set(want)
    for key, value in state.items():
        assert value.shape == want[key].shape, key
    port.load_state_dict(state, strict=True)
    n_leaves = len(jax.tree_util.tree_leaves(variables["params"])) + len(
        jax.tree_util.tree_leaves(variables.get("batch_stats", {}))
    )
    n_batch_norms = sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    assert len(state) == n_leaves + n_batch_norms  # plus num_batches_tracked


def test_torchvision_names() -> None:
    """The port's modules carry torchvision's names."""
    names = {
        "alexnet": ["features.0.weight", "features.10.bias"],
        "densenet121": [
            "features.conv0.weight",
            "features.denseblock1.denselayer1.conv1.weight",
            "features.transition3.norm.running_var",
            "features.norm5.weight",
        ],
        "mobilenet_v2": ["features.0.0.weight", "features.1.conv.0.0.weight", "features.2.conv.3.weight",
                         "features.18.1.weight"],
        "mobilenet_v3_large": ["features.0.1.weight", "features.4.block.2.fc1.weight", "features.16.0.weight"],
        "mobilenet_v3_small": ["features.1.block.1.fc2.bias", "features.12.0.weight"],
        "googlenet": ["conv1.conv.weight", "inception3a.branch2.1.bn.weight", "inception5b.branch4.1.conv.weight"],
        "inception_v3": ["Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.conv.weight",
                         "Mixed_7c.branch3x3dbl_3b.bn.running_mean"],
    }
    for backbone, keys in names.items():
        module, _ = get_backbone(backbone)
        state = module.state_dict()
        for key in keys:
            assert key in state, (backbone, key)


def test_feature_widths_match_the_jax_registry() -> None:
    from tiatoolbox_tpu.models.architecture import vanilla as jax_vanilla
    from tiatoolbox_tpu_torch.models.architecture import vanilla

    assert vanilla._FEATURE_WIDTHS == jax_vanilla._FEATURE_WIDTHS
    assert set(vanilla.backbone_dict) == set(jax_vanilla.backbone_dict)


@pytest.mark.parametrize("model_cls", [CNNModel, CNNBackbone])
def test_unknown_backbones_raise(model_cls) -> None:
    with pytest.raises(ValueError, match="not supported"):
        model_cls("vgg16", device="cpu")


def test_cnn_backbone_resnet_matches_flax() -> None:
    """``CNNBackbone`` over a ResNet: the ResNet converter, the flax features."""
    jax_model = JaxCNNBackbone("resnet18")
    shapes = jax.eval_shape(lambda: jax_model.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    variables = random_variables(shapes, seed=7)
    jax_model.load_weights(variables)
    port = CNNBackbone("resnet18", device="cpu")
    port.load_state_dict(flax_cnn_backbone_to_torch(variables, "resnet18"))
    batch = _batch(64, seed=8)
    got = CNNBackbone.infer_batch(port, batch)
    want = np.asarray(JaxCNNBackbone.infer_batch(jax_model, batch))
    assert got.shape == (2, 512)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_seeded_weights_are_reproducible_and_resnet_unchanged() -> None:
    """The same seed gives the same weights; the ResNet classifier draws the
    same numbers as before the zoo (``init_resnet_weights`` alone)."""
    from tiatoolbox_tpu_torch.models.architecture.resnet import RESNET_CONFIGS, ResNet, init_resnet_weights

    a = CNNModel("mobilenet_v3_small", num_classes=3, seed=4, device="cpu").state_dict()
    b = CNNModel("mobilenet_v3_small", num_classes=3, seed=4, device="cpu").state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    ref = torch.nn.Module()
    ref.feat_extract = ResNet(**RESNET_CONFIGS["resnet18"])
    ref.classifier = torch.nn.Linear(512, 9)
    init_resnet_weights(ref, torch.Generator().manual_seed(0))
    seeded = CNNModel("resnet18", num_classes=9, device="cpu").state_dict()
    for key, value in ref.state_dict().items():
        torch.testing.assert_close(seeded[key], value, rtol=0, atol=0)
