"""Registration on the card against the port's CPU run.

The card machine has neither JAX's flax nor cv2, so this file imports the
port only; ``tests/test_torch_registration.py`` holds the CPU run against
JAX. With TF32 off: VGG16's features within 1e-4 of their largest value,
DFBR's transform within 0.5 px of the CPU's, the dense field, the
sampler and its gradient, and Adam within float32 rounding, and 20
B-spline steps within 1e-3 px; the entry points run on the card when no
device is given. Run them there with
``python -m pytest -m cuda tests/test_torch_registration_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.tools.registration import wsi_registration as reg
from tiatoolbox_tpu_torch.utils.warp import resize_linear, warp_affine

pytestmark = pytest.mark.cuda

FEATURE_TOL = 1e-4  # of the largest |feature|
FIELD_TOL_PX = 1e-3  # 20 B-spline steps, card against the CPU
TRANSFORM_TOL_PX = 0.5  # DFBR's translation, card against the CPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card; chip_smoke.py's registration phase runs these checks there at full size")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture(scope="module")
def pair():
    """A 96^2 patch and its (4, 3) px shift, and a 256^2 patch and its (12, -8) px shift."""
    small = resize_linear(synthetic_he_patch((128, 128), seed=3), (96, 96))
    large = synthetic_he_patch((256, 256), seed=9)
    return (
        (small, warp_affine(small, np.array([[1, 0, 4.0], [0, 1, 3.0]]), (96, 96), border_value=255)),
        (large, warp_affine(large, np.array([[1, 0, -12.0], [0, 1, 8.0]]), (256, 256), border_value=243)),
    )


def test_entry_points_default_to_the_card(card, pair) -> None:
    assert reg.DFBRFeatureExtractor().device.type == "cuda"
    assert next(reg.DFBRFeatureExtractor().model.parameters()).is_cuda
    fixed, moving = pair[0]
    assert reg.estimate_bspline_transform(fixed, moving, n_iterations=2, grid_space=24).shape == (96, 96, 2)


@pytest.mark.parametrize("side", [64, 224])
def test_vgg16_features_against_the_cpu(card, side) -> None:
    image = np.random.default_rng(side).integers(0, 256, (side, side, 3), dtype=np.uint8)
    got = reg.DFBRFeatureExtractor((side, side), device=card)(image)
    want = reg.DFBRFeatureExtractor((side, side), device="cpu")(image)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= FEATURE_TOL * np.abs(w).max()


def test_dfbr_register_against_the_cpu(card, pair) -> None:
    fixed, moving = pair[1]
    got = reg.DFBRegister(device=card).register(fixed, moving)
    want = reg.DFBRegister(device="cpu").register(fixed, moving)
    assert np.abs(got[:2, 2] - want[:2, 2]).max() <= TRANSFORM_TOL_PX
    assert np.abs(got[:2, :2] - want[:2, :2]).max() <= TRANSFORM_TOL_PX / 256


def test_dense_field_sampler_and_gradient_against_the_cpu(card) -> None:
    rng = np.random.default_rng(4)
    control = rng.normal(0, 2, (32, 42, 2)).astype(np.float32)
    image = rng.random((1536, 2048)).astype(np.float32)
    results = []
    for device in (card, torch.device("cpu")):
        wy = torch.from_numpy(reg.cubic_resize_weights(32, 1536)).to(device)
        wx = torch.from_numpy(reg.cubic_resize_weights(42, 2048)).to(device)
        c = torch.from_numpy(control).to(device).requires_grad_()
        field = reg.dense_field(c, wy, wx)
        ys = torch.arange(1536, device=device, dtype=torch.float32)[:, None] + field[..., 1]
        xs = torch.arange(2048, device=device, dtype=torch.float32)[None, :] + field[..., 0]
        sampled = reg.sample_linear_nearest(torch.from_numpy(image).to(device), ys, xs)
        (grad,) = torch.autograd.grad(sampled.mean(), c)
        results.append([t.detach().cpu().numpy() for t in (field, sampled, grad)])
    for g, w in zip(*results):
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0)


def test_adam_step_against_the_cpu(card) -> None:
    states = {}
    for device in (card, torch.device("cpu")):
        control = torch.zeros((8, 9, 2), device=device)
        mu, nu = torch.zeros_like(control), torch.zeros_like(control)
        for count in range(1, 4):
            grad = torch.from_numpy(np.random.default_rng(count).normal(size=(8, 9, 2)).astype(np.float32)).to(device)
            control, mu, nu = reg.adam_step(control, grad, mu, nu, count, 0.5)
        states[device.type] = control.cpu().numpy()
    assert np.abs(states["cuda"] - states["cpu"]).max() <= 1e-6


def test_estimate_bspline_transform_against_the_cpu(card, pair) -> None:
    fixed, moving = pair[0]
    got = reg.estimate_bspline_transform(fixed, moving, n_iterations=20, grid_space=24, device=card)
    want = reg.estimate_bspline_transform(fixed, moving, n_iterations=20, grid_space=24, device="cpu")
    assert np.abs(got - want).max() <= FIELD_TOL_PX
