"""ResNet and CNNModel: the port against the flax models, in float32 on the CPU.

Random flax variables, batch-norm statistics included, are carried over with
``flax_resnet_to_torch``. Tolerances: feature maps and logits 1e-3 absolute,
softmax probabilities 1e-4 absolute (float32 convolutions summed in another
order by XLA and by PyTorch's CPU kernels).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture.resnet import ResNet as FlaxResNet
from tiatoolbox_tpu.models.architecture.vanilla import CNNModel as JaxCNNModel
from tiatoolbox_tpu.models.architecture.weight_converter import torch_resnet_to_flax
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
from tiatoolbox_tpu_torch.models.architecture.resnet import ResNet
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_resnet_to_torch
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _randomize(variables: dict, seed: int) -> dict:
    """Dense random weights and batch-norm statistics of the variables' shapes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel" and len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if name == "kernel":
            return rng.normal(0, np.sqrt(1.0 / shape[0]), shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def test_resnet_features_match_flax() -> None:
    flax_model = FlaxResNet(layers=(2, 2, 2, 2), block="basic")
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    variables = _randomize(flax_model.init(jax.random.PRNGKey(0), x), seed=1)
    want = np.asarray(flax_model.apply(variables, x))

    wrapped = {key: {"backbone": value} for key, value in variables.items()}
    state = {
        k.removeprefix("feat_extract."): v for k, v in flax_resnet_to_torch(wrapped).items()
    }
    port = ResNet(layers=(2, 2, 2, 2), block="basic").eval()
    port.load_state_dict(state)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("seed", [2, 3])
def test_cnn_model_logits_and_probabilities_match_flax(seed: int) -> None:
    jax_model = JaxCNNModel("resnet18", num_classes=9)
    jax_model.init(input_shape=(1, 64, 64, 3))
    variables = _randomize(jax_model.variables, seed)
    jax_model.load_weights(variables)
    batch = np.random.default_rng(seed).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)

    port = CNNModel("resnet18", num_classes=9, device="cpu")
    port.load_state_dict(flax_resnet_to_torch(variables))
    got = CNNModel.infer_batch(port, batch)
    want = np.asarray(JaxCNNModel.infer_batch(jax_model, batch))
    assert got.dtype == np.float32 and got.shape == (3, 9)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    x = batch.astype(np.float32) / 255.0
    feats = FlaxResNet(layers=(2, 2, 2, 2), block="basic").apply(
        {k: v["backbone"] for k, v in variables.items()}, x
    )
    head = variables["params"]["classifier"]
    want_logits = np.asarray(feats).mean(axis=(1, 2)) @ head["kernel"] + head["bias"]
    with torch.inference_mode():
        got_logits = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-3, rtol=0)


def test_state_dict_round_trips_through_the_jax_converter() -> None:
    port = CNNModel("resnet18", num_classes=9, seed=4, device="cpu")
    state = port.state_dict()
    flax_vars = torch_resnet_to_flax({k: v.numpy() for k, v in state.items()})
    back = flax_resnet_to_torch(flax_vars)
    assert set(back) == set(state)
    for key, value in state.items():
        torch.testing.assert_close(back[key], value.contiguous(), rtol=0, atol=0)


def test_apply_u8_scales_and_stage_batch_stays_on_cpu() -> None:
    port = CNNModel("resnet18", num_classes=4, seed=5, device="cpu")
    batch = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    staged = port.stage_batch(batch)
    assert staged.device.type == "cpu" and staged.dtype == torch.uint8
    assert port.stage_batch(staged) is staged
    with torch.inference_mode():
        want = port(torch.from_numpy(batch).float() / 255.0)
    torch.testing.assert_close(port.apply_u8(staged), want, rtol=0, atol=0)
    torch.testing.assert_close(port.apply_u8(staged.float() / 255.0), want, rtol=0, atol=0)
    seeded = CNNModel("resnet18", num_classes=4, seed=5, device="cpu").state_dict()
    for key, value in port.state_dict().items():
        torch.testing.assert_close(seeded[key], value, rtol=0, atol=0)


def test_models_run_on_cuda_unless_the_cpu_is_asked_for(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNNModel("resnet18", num_classes=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_pretrained_model("resnet18-kather100k")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PatchPredictor("resnet18-kather100k", verbose=False)
    port = CNNModel("resnet18", num_classes=2, device="cpu")
    batch = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNNModel.infer_batch(port, batch, device="cuda")
    assert port.device.type == "cpu"
    assert CNNModel.infer_batch(port, batch, device="cpu").shape == (1, 2)
    model, _ = get_pretrained_model("resnet18-kather100k", device="cpu")
    assert model.device.type == "cpu"
