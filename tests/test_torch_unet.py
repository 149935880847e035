"""UNetModel and the architecture utilities: the port against the flax models on the CPU.

Weights: the port's seeded model gets random batch-norm scales and shifts,
then batch-norm statistics taken from a batch of random patches (one forward
in training mode), so activations stay finite and depend on the input. Two
choices keep the random network at the scale of a trained one: the last
batch norm of each resnet50 bottleneck starts at a fifth of its scale (as
torchvision's ``zero_init_residual`` starts it at zero), and the classifier
at 0.3 of its initial scale, so logits are a few units. The state goes to
flax with the JAX package's ``torch_unet_to_flax`` and back into the port
with ``flax_unet_to_torch``.

Tolerances, float32: probabilities 1e-4 absolute, logits 1e-4 of max
|logit| (float32 convolutions summed in another order by XLA and by
PyTorch's CPU kernels). bfloat16 (the repair of a compute dtype that used to
crash): bf16 rounding moves the probabilities of these random networks by
0.04-0.2 in both frameworks (measured, JAX's bf16 model against its float32
one), more than the 2e-2 that holds for the resnet18 classifier
(``tests/test_torch_resnet.py``). So the port's bf16 error against its own
float32 output is held to at most 1.5 times JAX's, and the two bf16 models
to at most twice JAX's bf16 error apart.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.architecture.weight_converter import torch_unet_to_flax
from tiatoolbox_tpu_torch.models.architecture import utils
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_unet_to_torch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


RESNET50 = dict(num_input_channels=3, num_output_channels=5, encoder="resnet50", decoder_block=(3, 3))
NARROW = dict(num_input_channels=3, num_output_channels=2, encoder="unet", encoder_levels=(8, 16, 32))


def calibrated_state(kwargs: dict, seed: int) -> dict[str, torch.Tensor]:
    """A seeded port model's ``state_dict`` with batch-norm statistics from a batch."""
    model = UNetModel(**kwargs, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)

    def draw(values: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(values.astype(np.float32))

    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                scale = 0.2 if name.endswith("bn3") else 1.0
                module.weight.copy_(draw(scale * rng.uniform(0.5, 1.5, module.weight.shape)))
                module.bias.copy_(draw(rng.normal(0, 0.1, module.bias.shape)))
                module.reset_running_stats()
                module.momentum = None
            elif isinstance(module, torch.nn.Conv2d) and module.bias is not None:
                module.bias.copy_(draw(rng.normal(0, 0.1, module.bias.shape)))
        model.clf.weight.mul_(0.3)
        model.train()
        model(torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)).float() / 255)
    model.eval()
    return model.state_dict()


def flax_variables(state: dict[str, torch.Tensor]) -> dict:
    return torch_unet_to_flax({k: v.numpy() for k, v in state.items()})


def _batch(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


def _pair(kwargs: dict, variables: dict, dtype=None):
    port = UNetModel(**kwargs, compute_dtype=dtype, device="cpu")
    port.load_state_dict(flax_unet_to_torch(variables))
    jax_model = JaxUNetModel(**kwargs, compute_dtype=jnp.float32 if dtype is None else jnp.bfloat16)
    jax_model.load_weights(variables)
    if dtype is not None:
        jax_model.optimize_for_inference()
    return port, jax_model


@pytest.fixture(scope="module")
def resnet50_variables() -> dict:
    return flax_variables(calibrated_state(RESNET50, seed=1))


def _assert_matches_jax(kwargs: dict, variables: dict, seed: int) -> None:
    port, jax_model = _pair(kwargs, variables)
    batch = _batch(seed)
    got = UNetModel.infer_batch(port, batch)
    want = np.asarray(JaxUNetModel.infer_batch(jax_model, batch))
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 32, 32, kwargs["num_output_channels"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    with torch.inference_mode():
        got_logits = port(torch.from_numpy(batch).float() / 255).numpy()
    want_logits = np.asarray(jax_model.module.apply(variables, jnp.asarray(batch, jnp.float32)))
    scale = float(np.abs(want_logits).max())
    assert float(np.abs(got_logits - want_logits).max()) <= 1e-4 * scale
    # the input matters: probabilities are not one constant map
    assert float(got.std(axis=(0, 1, 2)).max()) > 1e-3


def test_resnet50_unet_matches_flax_at_full_width(resnet50_variables: dict) -> None:
    _assert_matches_jax(RESNET50, resnet50_variables, seed=5)


@pytest.mark.parametrize("skip_type", ["add", "concat"])
def test_narrow_unet_encoder_matches_flax(skip_type: str) -> None:
    kwargs = {**NARROW, "skip_type": skip_type}
    _assert_matches_jax(kwargs, flax_variables(calibrated_state(kwargs, seed=2)), seed=6)


@pytest.mark.parametrize(
    "kwargs",
    [RESNET50, {**RESNET50, "num_input_channels": 4}, {**NARROW, "skip_type": "concat"}],
    ids=["resnet50", "resnet50_4ch_conv1_bias", "unet_concat"],
)
def test_state_dict_round_trips_through_the_jax_converter(kwargs: dict) -> None:
    state = UNetModel(**kwargs, seed=3, device="cpu").state_dict()
    back = flax_unet_to_torch(flax_variables(state))
    assert set(back) == set(state)
    for key, value in state.items():
        torch.testing.assert_close(back[key], value.contiguous(), rtol=0, atol=0)
    assert ("backbone.conv1.bias" in state) == (kwargs["num_input_channels"] != 3 and kwargs["encoder"] == "resnet50")


@pytest.mark.parametrize("kwargs", [NARROW, RESNET50], ids=["unet", "resnet50"])
def test_bf16_unet_runs_and_is_as_close_to_float32_as_flax(kwargs: dict, resnet50_variables: dict) -> None:
    variables = (
        resnet50_variables if kwargs is RESNET50 else flax_variables(calibrated_state(kwargs, seed=4))
    )
    batch = _batch(8)
    port, jax_model = _pair(kwargs, variables)
    port_bf16, jax_bf16 = _pair(kwargs, variables, torch.bfloat16)
    assert {p.dtype for p in port_bf16.parameters()} == {torch.bfloat16}
    got = UNetModel.infer_batch(port_bf16, batch)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    want = np.asarray(JaxUNetModel.infer_batch(jax_bf16, batch))
    jax_err = np.abs(want - np.asarray(JaxUNetModel.infer_batch(jax_model, batch))).max()
    port_err = np.abs(got - UNetModel.infer_batch(port, batch)).max()
    assert 0 < port_err <= 1.5 * jax_err
    assert np.abs(got - want).max() <= 2 * jax_err


def test_bilinear_upsample_matches_jax_on_border_rows_and_columns() -> None:
    x = np.random.default_rng(9).random((2, 7, 9, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(x, (2, 14, 18, 3), method="bilinear"))
    got = utils.resize_bilinear(torch.from_numpy(x), 2).numpy()
    for name, sl in {
        "top row": np.s_[:, 0],
        "bottom row": np.s_[:, -1],
        "left column": np.s_[:, :, 0],
        "right column": np.s_[:, :, -1],
    }.items():
        np.testing.assert_allclose(got[sl], want[sl], atol=1e-6, rtol=0, err_msg=name)
    # each corner is the input's corner pixel itself, in both (to rounding)
    for corner in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        np.testing.assert_allclose(got[:, corner[0], corner[1]], x[:, corner[0], corner[1]], atol=1e-6)
        np.testing.assert_allclose(want[:, corner[0], corner[1]], x[:, corner[0], corner[1]], atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    nchw = utils.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 2, "NCHW")
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), got)


def test_crop_and_nearest_upsample_match_jax() -> None:
    from tiatoolbox_tpu.models.architecture import utils as jax_utils

    x = np.random.default_rng(10).random((2, 9, 11, 3), dtype=np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        utils.upsample2x(t).numpy(), np.asarray(jax_utils.upsample2x(jnp.asarray(x)))
    )
    for crop in ((0, 0), (3, 4), (4, 1)):
        np.testing.assert_array_equal(
            utils.centre_crop(t, crop).numpy(), np.asarray(jax_utils.centre_crop(x, crop))
        )
        np.testing.assert_array_equal(
            utils.centre_crop(t.permute(0, 3, 1, 2), crop, "NCHW").numpy(),
            np.asarray(jax_utils.centre_crop(x.transpose(0, 3, 1, 2), crop, "NCHW")),
        )
    y = np.zeros((2, 5, 6, 3), np.float32)
    np.testing.assert_array_equal(
        utils.centre_crop_to_shape(t, torch.from_numpy(y)).numpy(),
        np.asarray(jax_utils.centre_crop_to_shape(x, y)),
    )
    with pytest.raises(ValueError, match="smaller"):
        utils.centre_crop_to_shape(torch.from_numpy(y), t)
    with pytest.raises(ValueError, match="Unknown input format"):
        utils.centre_crop(t, (1, 1), "HWNC")
    probs = np.random.default_rng(11).random((4, 5, 3))
    np.testing.assert_array_equal(utils.argmax_last_axis(probs), jax_utils.argmax_last_axis(probs))
    np.testing.assert_array_equal(
        utils.argmax_last_axis(torch.from_numpy(probs)).numpy(), probs.argmax(-1)
    )


def test_unet_rejects_unknown_encoder_and_skip() -> None:
    with pytest.raises(ValueError, match="Unknown encoder"):
        UNetModel(encoder="vgg", device="cpu")
    with pytest.raises(ValueError, match="skip connection"):
        UNetModel(skip_type="mul", device="cpu")
