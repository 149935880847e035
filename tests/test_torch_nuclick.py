"""NuClick and ``nuclick_light-pannuke``: the port against the JAX package on the CPU.

NuClick's weights are drawn for the port's ``state_dict``
(``torch_seeded.seeded_state``), carried to flax by JAX's
``torch_nuclick_to_flax`` and back by ``flax_nuclick_to_torch`` (the same
``state_dict``, transpose-conv kernels included), and the same 5-channel
batches (an RGB patch over 255 and the inclusion and exclusion click maps
of seeded points) run through both ``infer_batch``es at the registry's
128^2: sigmoids within 1e-4, logits within 1e-4 of their largest magnitude.
``postproc`` must equal JAX's bit for bit with and without clicks, the
warning path (a click on no nucleus) included. ``nuclick_light-pannuke`` is
the registry's 5-channel U-Net (``unet`` encoder, 32-256 wide), whose wire
is a float 5-channel batch that both packages divide by 255.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from torch_seeded import assert_same_state, seeded_state
from tiatoolbox_tpu.models.architecture.nuclick import NuClick as JaxNuClick
from tiatoolbox_tpu.models.architecture.unet import UNetModel as JaxUNetModel
from tiatoolbox_tpu.models.architecture.weight_converter import torch_nuclick_to_flax, torch_unet_to_flax
from tiatoolbox_tpu_torch import PRETRAINED_MODELS
from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model, load_weights
from tiatoolbox_tpu_torch.models.architecture import nuclick as nuclick_module
from tiatoolbox_tpu_torch.models.architecture.nuclick import NuClick
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from tiatoolbox_tpu_torch.models.architecture.weight_converter import flax_nuclick_to_torch, flax_unet_to_torch

PROB_TOL = 1e-4
LOGIT_TOL = 1e-4
SIZE = 128  # the registry's patch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def click_batch(n: int, size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``[n, size, size, 5]`` float32 inputs (RGB / 255, inclusion map of one
    click, exclusion map of the other clicks) and the inclusion maps."""
    rng = np.random.default_rng(seed)
    rgb = np.stack([synthetic_he_patch((size, size), seed=seed + i) for i in range(n)]).astype(np.float32) / 255
    points = rng.integers(8, size - 8, (n, 3, 2))
    inc = np.zeros((n, size, size), np.float32)
    exc = np.zeros((n, size, size), np.float32)
    for i in range(n):
        inc[i, points[i, 0, 0], points[i, 0, 1]] = 1
        exc[i, points[i, 1:, 0], points[i, 1:, 1]] = 1
    return np.concatenate([rgb, inc[..., None], exc[..., None]], axis=-1), inc


@pytest.fixture(scope="module")
def nuclick_pair():
    port = NuClick(5, 1, device="cpu")
    state = seeded_state(port, 1)
    port.load_state_dict(state, strict=True)
    variables = torch_nuclick_to_flax({k: v.numpy() for k, v in state.items()})
    assert_same_state(flax_nuclick_to_torch(variables), state)
    jax_model = JaxNuClick(5, 1)
    jax_model.load_weights(variables)
    return jax_model, port, variables


def _logits_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_TOL * float(np.abs(want).max())


def test_nuclick_matches_flax(nuclick_pair) -> None:
    jax_model, port, variables = nuclick_pair
    batch, _ = click_batch(2, SIZE, seed=2)
    want = np.asarray(JaxNuClick.infer_batch(jax_model, batch))
    got = NuClick.infer_batch(port, batch)
    assert got.shape == want.shape == (2, SIZE, SIZE) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= PROB_TOL
    with torch.inference_mode():
        _logits_close(port(torch.from_numpy(batch)), jax.jit(jax_model.module.apply)(variables, batch))


def test_upstream_names_and_load(nuclick_pair, tmp_path) -> None:
    _, port, _ = nuclick_pair
    state = port.state_dict()
    for key in (
        "conv_block_1.0.conv_bn_relu.0.weight",
        "conv_block_1.2.conv_bn_relu.1.running_var",
        "residual_block_1.1.conv_block_2.conv_bn_relu.1.weight",
        "residual_block_2.conv_block_1.conv_bn_relu.0.weight",
        "multiscale_block_3.conv_block_4.conv_bn_relu.0.weight",
        "residual_block_7.1.conv_block_1.conv_bn_relu.0.weight",
        "conv_transpose_1.weight",
        "conv_transpose_5.bias",
        "conv_block_2.2.conv_bn_relu.1.bias",
        "conv_block_3.conv_bn_relu.0.bias",
    ):
        assert key in state, key
    assert state["conv_transpose_1.weight"].shape == (1024, 512, 2, 2)
    assert state["multiscale_block_3.conv_block_4.conv_bn_relu.0.weight"].shape == (16, 64, 7, 7)
    assert port.multiscale_block_3.conv_block_4.conv_bn_relu[0].dilation == (6, 6)
    torch.save({"state_dict": state}, tmp_path / "n.pth")
    fresh = NuClick(5, 1, seed=3, device="cpu")
    load_weights(fresh, tmp_path / "n.pth")
    assert_same_state(fresh.state_dict(), state)


def _prob_maps(n: int, size: int, seed: int) -> np.ndarray:
    """Maps of separate nuclei: discs of every size (specks under any
    ``min_size`` among them) on a noisy background, one with an interior
    hole of 16 pixels, one cut by the border with a hole on it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    maps = rng.uniform(0.0, 0.3, (n, size, size))
    for i in range(n):
        for cy, cx, r in zip(rng.integers(0, size, 14), rng.integers(0, size, 14), rng.uniform(1, 9, 14)):
            maps[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.uniform(0.4, 1.0)
    maps[:, 40:60, 40:60] = 0.9
    maps[:, 47:51, 47:51] = 0.1  # an interior hole
    maps[:, 0:12, 70:90] = 0.9
    maps[:, 0:4, 75:80] = 0.1  # a hole open to the border
    return maps.astype(np.float32)


@pytest.mark.parametrize(("thresh", "min_size", "min_hole_size"), [(0.33, 10, 30), (0.6, 5, 10), (0.5, 40, 60)])
def test_postproc_equals_jax_bit_for_bit(thresh: float, min_size: int, min_hole_size: int, monkeypatch) -> None:
    maps = _prob_maps(3, 100, seed=4)
    kwargs = dict(thresh=thresh, min_size=min_size, min_hole_size=min_hole_size)
    got = NuClick.postproc(maps, **kwargs)
    want = JaxNuClick.postproc(maps, **kwargs)
    assert got.dtype == want.dtype == bool and got.shape == maps.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    # clicks: one on an object, and one on the background (the warning path)
    points = np.zeros_like(maps)
    points[0, 50, 42] = 1
    points[2, 48, 49] = 1  # inside the filled hole
    warnings: list[str] = []
    monkeypatch.setattr(nuclick_module.logger, "warning", lambda msg, *a: warnings.append(msg))
    background = np.argwhere(~want[1])[0]
    points[1, background[0], background[1]] = 1
    got = NuClick.postproc(maps, **kwargs, nuc_points=points, do_reconstruction=True)
    want = JaxNuClick.postproc(maps, **kwargs, nuc_points=points, do_reconstruction=True)
    np.testing.assert_array_equal(got, want)
    # image 1's click, and image 2's where its 16-pixel hole stays open
    assert warnings == ["No nuclei found at the click point; returning raw mask."] * (1 if min_hole_size > 16 else 2)
    np.testing.assert_array_equal(got[1], NuClick.postproc(maps[1:2], **kwargs)[0])  # the raw mask
    assert 0 < got[0].sum() < NuClick.postproc(maps[0:1], **kwargs)[0].sum()  # only the clicked object
    if min_hole_size > 16:
        assert got[2, 48, 49]  # the hole was filled, so its click finds the nucleus


def test_nuclick_light_matches_flax() -> None:
    """``nuclick_light-pannuke`` at its registry width on a float 5-channel wire."""
    kwargs = PRETRAINED_MODELS["nuclick_light-pannuke"]["architecture"]["kwargs"]
    port, ioconfig = get_pretrained_model("nuclick_light-pannuke", device="cpu")
    assert isinstance(port, UNetModel) and list(ioconfig.patch_input_shape) == [SIZE, SIZE]
    state = seeded_state(port, 5)
    port.load_state_dict(state, strict=True)
    variables = torch_unet_to_flax({k: v.numpy() for k, v in state.items()})
    assert_same_state(flax_unet_to_torch(variables), state)
    jax_model = JaxUNetModel(**kwargs)
    jax_model.load_weights(variables)
    batch, _ = click_batch(2, SIZE, seed=6)
    wire = batch * 255  # both packages divide the wire by 255
    want = np.asarray(JaxUNetModel.infer_batch(jax_model, wire))
    got = UNetModel.infer_batch_device(port, wire).numpy()
    assert got.shape == want.shape == (2, SIZE // 2, SIZE // 2, 1)
    assert float(np.abs(got - want).max()) <= PROB_TOL
    np.testing.assert_array_equal(UNetModel.postproc(got), JaxUNetModel.postproc(want))  # the argmax
    with torch.inference_mode():
        _logits_close(port(torch.from_numpy(batch)), jax.jit(jax_model.module.apply)(variables, wire))
    assert port.backbone.blocks[0][0][0].in_channels == 5
