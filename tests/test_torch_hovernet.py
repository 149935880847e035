"""HoVerNet: the port's network and weight conversion against the flax model on the CPU.

Both modes run at full width: one 256x256 "fast" patch and one 270x270
"original" patch, with random flax variables (batch-norm statistics and
affine terms drawn from a seeded numpy generator so every unit matters)
carried into the port with ``flax_hovernet_to_torch``, and the fast model
with the functional checkpoint of ``scripts/make_bench_checkpoints.py``.

Tolerances, float32: logits within 1e-4 of their largest magnitude (the
convolutions sum in another order in XLA and in PyTorch's CPU kernels, over
a network 100 convolutions deep); foreground probabilities and hv maps
within 1e-4 of their largest magnitude; the type argmax equal wherever the
top two type probabilities are more than 1e-3 apart. The SAME padding of a
stride-2 convolution and the weight conversion are exact.
"""

from __future__ import annotations

import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
from tiatoolbox_tpu.models.architecture.weight_converter import torch_hovernet_to_flax
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet, TFSamepaddingLayer
from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import (
    flax_layout,
    functional_hovernet_state_dict,
)
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_hovernet_to_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _random_variables(num_types, mode: str, seed: int) -> dict:
    """Seeded flax variables in the flax module's layout: He-normal kernels,
    random batch-norm terms, random biases."""
    rng = np.random.default_rng(seed)

    def fill(tree: dict) -> dict:
        out = {}
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                out[key] = fill(value)
            elif key == "kernel":
                fan_in = int(np.prod(value.shape[:3]))
                out[key] = rng.normal(0, np.sqrt(2.0 / fan_in), value.shape).astype(np.float32)
            elif key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5 if key == "var" else 1.0, value.shape).astype(np.float32)
            else:  # bias, mean
                out[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        return out

    return fill(flax_layout(num_types, mode))


def _flax_shapes(num_types, mode: str) -> dict:
    """Shapes of the flax module's variables, traced without running its initialisers."""
    size = 256 if mode == "fast" else 270
    module = JaxHoVerNet(num_types=num_types, mode=mode).module
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(tree))


class _ShapeOnlyModel:
    """Stands in for the JAX ``HoVerNet`` given to the bench script's
    ``build_functional_hovernet_variables``, which calls ``model.init()``
    only for the variables' tree and zeroes every
    value: the tree comes from ``jax.eval_shape`` (running the initialisers
    takes most of a minute on a CPU)."""

    def __init__(self, num_types, mode: str) -> None:
        self.num_types, self.mode = num_types, mode

    def init(self) -> None:
        shapes = _flax_shapes(self.num_types, self.mode)
        self.variables = jax.tree_util.tree_map(
            lambda shape: np.zeros(shape, np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple)
        )


@pytest.fixture(scope="module")
def script_variables() -> dict:
    """``build_functional_hovernet_variables`` of ``scripts/make_bench_checkpoints.py``."""
    from make_bench_checkpoints import build_functional_hovernet_variables

    return build_functional_hovernet_variables(_ShapeOnlyModel(6, "fast"))


def _close(got: np.ndarray, want: np.ndarray, rel: float = 1e-4) -> None:
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs diff {err} > {rel} * {scale}"


def _forward_both(jax_model: JaxHoVerNet, variables: dict, port: HoVerNet, patch: np.ndarray):
    """Logits and head outputs of both models on one uint8 batch."""
    want_logits = jax.jit(jax_model.module.apply)(variables, jnp.asarray(patch, jnp.float32))
    with torch.inference_mode():
        got_logits = port(torch.from_numpy(patch).float())
    want = [np.asarray(v) for v in JaxHoVerNet._head_outputs(want_logits).values()]
    got = [v.numpy() for v in HoVerNet._head_outputs(got_logits)]
    return got_logits, want_logits, got, want


def _assert_heads_match(got: list, want: list, want_logits: dict, min_clear: float = 0.0) -> None:
    """np and hv within 1e-4 of their scale; the tp argmax equal where it is clear."""
    _close(got[0], want[0])
    _close(got[1], want[1])
    if "tp" in want_logits:
        probs = np.sort(np.asarray(jax.nn.softmax(want_logits["tp"], axis=-1)), axis=-1)
        clear = (probs[..., -1] - probs[..., -2]) > 1e-3
        assert clear.mean() >= min_clear
        np.testing.assert_array_equal(got[2][..., 0][clear], want[2][..., 0][clear])


@pytest.mark.parametrize(("mode", "num_types", "size"), [("fast", 6, 256), ("original", 5, 270)])
def test_forward_matches_flax_with_random_variables(mode: str, num_types: int, size: int) -> None:
    jax_model = JaxHoVerNet(num_types=num_types, mode=mode)
    variables = _random_variables(num_types, mode, seed=size)
    port = HoVerNet(num_types=num_types, mode=mode, device="cpu")
    port.load_state_dict(flax_hovernet_to_torch(variables))
    patch = np.random.default_rng(size).integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    got_logits, want_logits, got, want = _forward_both(jax_model, variables, port, patch)
    out = 164 if mode == "fast" else 80
    for name in ("np", "hv", "tp"):
        assert got_logits[name].shape == (1, out, out, 2 if name != "tp" else num_types)
        _close(got_logits[name].numpy(), np.asarray(want_logits[name]))
    _assert_heads_match(got, want, want_logits, min_clear=0.5)


def test_forward_matches_flax_with_the_functional_checkpoint(script_variables: dict) -> None:
    jax_model = JaxHoVerNet(num_types=6, mode="fast")
    variables = script_variables
    port = HoVerNet(num_types=6, mode="fast", device="cpu")
    port.load_state_dict(functional_hovernet_state_dict())
    patch = synthetic_he_patch((256, 256), seed=3)[None]
    _, want_logits, got, want = _forward_both(jax_model, variables, port, patch)
    _assert_heads_match(got, want, want_logits)
    # the engine's entry point gives the same heads
    for a, b in zip(HoVerNet.infer_batch(port, patch), got):
        np.testing.assert_array_equal(a, b)
    # a working nucleus detector: a share of the patch is foreground
    assert 0.02 < float((got[0] >= 0.5).mean()) < 0.6


def test_functional_checkpoint_equals_the_scripts_tensor_for_tensor(script_variables: dict) -> None:
    want = flax_hovernet_to_torch(script_variables)
    got = functional_hovernet_state_dict(num_types=6, mode="fast")
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    HoVerNet(num_types=6, mode="fast", device="cpu").load_state_dict(got)


@pytest.mark.parametrize(("mode", "num_types"), [("fast", 6), ("original", None)])
def test_converter_inverts_torch_hovernet_to_flax_name_for_name(mode: str, num_types) -> None:
    port = HoVerNet(num_types=num_types, mode=mode, seed=4, device="cpu")
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if buf.is_floating_point():
                buf.copy_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(len(name))))
    state = port.state_dict()
    flax_vars = torch_hovernet_to_flax({k: v.numpy() for k, v in state.items()})
    back = flax_hovernet_to_torch(flax_vars)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    # the converted tree, and the port's flax layout, are the flax module's variables
    shapes = _flax_shapes(num_types, mode)
    assert jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), flax_vars) == shapes
    layout = jax.tree_util.tree_map(lambda a: tuple(a.shape), flax_layout(num_types, mode))
    assert layout == shapes


@pytest.mark.parametrize(("size", "stride", "ksize"), [(8, 2, 3), (9, 2, 3), (7, 2, 3), (12, 1, 7), (11, 1, 3)])
def test_same_padding_matches_flax(size: int, stride: int, ksize: int) -> None:
    rng = np.random.default_rng(size * 10 + ksize)
    x = rng.normal(size=(1, size, size + 1, 4)).astype(np.float32)
    conv = nn.Conv(5, (ksize, ksize), strides=(stride, stride), padding="SAME", use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)
    port = torch.nn.Conv2d(4, 5, ksize, stride=stride, bias=False)
    port.weight.data = torch.from_numpy(np.ascontiguousarray(kernel))
    with torch.no_grad():
        got = port(TFSamepaddingLayer(ksize, stride)(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)
    if stride == 2 and size % 2 == 0:
        # flax pads 0 before and 1 after on an even input, not 1 and 1
        symmetric = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), port.weight, stride=2, padding=1
        )
        assert not np.allclose(symmetric.detach().permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


def test_registry_builds_the_four_hovernet_entries() -> None:
    import yaml

    reference = yaml.safe_load(
        (Path(__file__).resolve().parents[1] / "tiatoolbox_tpu/data/pretrained_model.yaml").read_text()
    )
    for name in ("hovernet_fast-pannuke", "hovernet_fast-monusac", "hovernet_original-consep", "hovernet_original-kumar"):
        entry = PRETRAINED_MODELS[name]
        assert entry["architecture"] == reference[name]["architecture"]
        assert entry["ioconfig"] == reference[name]["ioconfig"]
    model, ioconfig = get_pretrained_model("hovernet_original-kumar", device="cpu")
    assert isinstance(model, HoVerNet) and model.mode == "original" and model.num_types is None
    assert ioconfig.margin == 128 and list(ioconfig.patch_output_shape) == [80, 80]
    assert "tp" not in model.decoder and list(model.decoder) == ["np", "hv"]
