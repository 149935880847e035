"""The classifier zoo, the encoders and the feature engine on the card against the CPU.

These tests import the port only: the card machine has jax but no flax, so
the parity files that import the JAX package's models
(``test_torch_cnn_backbones.py``, ``test_torch_efficientnet.py``,
``test_torch_vit.py``, ``test_torch_feature_extractor.py``) cannot be
collected there. Each test holds a module on the card against the same
weights on the CPU, float32 with TF32 off, and skips without a card. Run
them on the card with ``python -m pytest -m cuda tests/test_torch_zoo_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.models.architecture import efficientnet, vit
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone, CNNModel
from tiatoolbox_tpu_torch.models.engine import DeepFeatureExtractor

TOL = 1e-4
FAMILIES = ("alexnet", "densenet121", "mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large", "googlenet",
            "inception_v3", "resnext50_32x4d")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's zoo and features phases run these checks on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _patches(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", FAMILIES)
@pytest.mark.parametrize("size", [96, 97])
def test_classifier_on_the_card_matches_the_cpu(card, backbone: str, size: int) -> None:
    """Softmax within 1e-4, and the backbone's feature map within 1e-4 of its
    largest |value|, at an even and an odd size (XLA's "SAME" pads)."""
    cpu = CNNModel(backbone, num_classes=5, device="cpu")
    on_card = CNNModel(backbone, num_classes=5, device=card)
    on_card.load_state_dict(cpu.state_dict())
    batch = _patches(2, size, seed=size)
    np.testing.assert_allclose(CNNModel.infer_batch(on_card, batch), CNNModel.infer_batch(cpu, batch), atol=TOL, rtol=0)
    x = torch.from_numpy(batch).float() / 255.0
    with torch.inference_mode():
        _close(on_card.feat_extract(x.to(card)).cpu().numpy(), cpu.feat_extract(x).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["efficientnet_b0", "efficientnetv2_s"])
def test_efficientnet_stages_on_the_card_match_the_cpu(card, variant: str) -> None:
    cls = efficientnet.EfficientNetV2Encoder if variant.startswith("efficientnetv2") else efficientnet.EfficientNetEncoder
    cpu = cls(variant).eval()
    on_card = cls(variant).eval().to(card)
    on_card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).random((2, 96, 96, 3), dtype=np.float32))
    with torch.inference_mode():
        for got, want in zip(on_card(x.to(card)), cpu(x)):
            _close(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["H0-mini", "efficientnet_b0"])
def test_timm_backbone_on_the_card_matches_the_cpu(card, backbone: str) -> None:
    """H0-mini (registers, SwiGLU; layer scales set to 0.5 so the blocks count)
    and EfficientNet-B0 through ``TimmBackbone``."""
    cpu = vit.TimmBackbone(backbone, device="cpu")
    with torch.no_grad():
        for name, param in cpu.named_parameters():
            if name.endswith("gamma"):
                param.fill_(0.5)
    on_card = vit.TimmBackbone(backbone, device=card)
    on_card.load_state_dict(cpu.state_dict())
    batch = _patches(2, 224, seed=2)
    _close(vit.TimmBackbone.infer_batch(on_card, batch), vit.TimmBackbone.infer_batch(cpu, batch))


@pytest.mark.cuda
def test_feature_extractor_on_the_card_matches_the_cpu(card) -> None:
    cpu = CNNBackbone("resnet50", device="cpu")
    on_card = CNNBackbone("resnet50", device=card)
    on_card.load_state_dict(cpu.state_dict())
    patches = _patches(5, 96, seed=3)
    want = DeepFeatureExtractor(model=cpu, batch_size=2, verbose=False, device="cpu").run(patches)["features"]
    got = DeepFeatureExtractor(model=on_card, batch_size=2, verbose=False, device="cuda").run(patches)["features"]
    _close(got, want)
