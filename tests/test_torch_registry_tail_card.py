"""KongNet, the tissue masks and NuClick on the card against the CPU.

These tests import the port only (the card machine has jax but no flax).
Each builds a model on the CPU with seeded weights (``torch_seeded``), the
same model on the card, and holds the card's outputs against the CPU's in
float32 with TF32 off: sigmoid and softmax maps within 1e-4, logits within
1e-4 of their largest magnitude. They skip without a card; run them there
with ``python -m pytest -m cuda tests/test_torch_registry_tail_card.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture.efficientunet_tissue_mask_model import EfficientUNetTissueMaskModel
from tiatoolbox_tpu_torch.models.architecture.grandqc import GrandQCModel
from tiatoolbox_tpu_torch.models.architecture.kongnet import KongNet
from tiatoolbox_tpu_torch.models.architecture.nuclick import NuClick
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
from torch_seeded import seeded_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PROB_TOL = 1e-4
LOGIT_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's registry_tail phase runs these checks on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(make, seed: int, card):
    cpu = make("cpu")
    cpu.load_state_dict(seeded_state(cpu, seed))
    on_card = make(card)
    on_card.load_state_dict(cpu.state_dict())
    return cpu, on_card


def _held(cpu, on_card, batch: np.ndarray) -> None:
    got = type(cpu).infer_batch(on_card, batch)
    want = type(cpu).infer_batch(cpu, batch)
    assert got.shape == want.shape and float(np.abs(got - want).max()) <= PROB_TOL
    x = torch.from_numpy(batch)
    with torch.inference_mode():
        got_logits = on_card(x.to(on_card.device)).cpu()
        want_logits = cpu(x)
    assert float((got_logits - want_logits).abs().max()) <= LOGIT_TOL * float(want_logits.abs().max())


def _he(n: int, size: int, seed: int) -> np.ndarray:
    return np.stack([synthetic_he_patch((size, size), seed=seed + i) for i in range(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_kongnet_on_the_card_matches_the_cpu(card, wide: bool) -> None:
    cpu, on_card = _pair(lambda d: KongNet(2, [3, 3], [2, 5], 3, 0.5, variant="efficientnetv2_s",
                                           wide_decoder=wide, device=d), 1, card)
    _held(cpu, on_card, np.stack([KongNet.preproc(p) for p in _he(2, 96, seed=2)]))


@pytest.mark.cuda
@pytest.mark.parametrize("model_cls", [GrandQCModel, EfficientUNetTissueMaskModel])
def test_tissue_models_on_the_card_match_the_cpu(card, model_cls) -> None:
    cpu, on_card = _pair(lambda d: model_cls(device=d), 3, card)
    _held(cpu, on_card, np.stack([model_cls.preproc(p) for p in _he(2, 128, seed=4)]))


@pytest.mark.cuda
def test_nuclick_models_on_the_card_match_the_cpu(card) -> None:
    batch = np.concatenate([_he(2, 128, seed=5) / 255.0, np.zeros((2, 128, 128, 2))], axis=-1).astype(np.float32)
    batch[0, 60, 70, 3] = batch[1, 30, 40, 3] = batch[0, 20, 20, 4] = 1
    cpu, on_card = _pair(lambda d: NuClick(device=d), 6, card)
    _held(cpu, on_card, batch)
    cpu, on_card = _pair(
        lambda d: UNetModel(5, 1, encoder="unet", encoder_levels=[32, 64, 128, 256], decoder_block=[3, 3], device=d),
        7, card,
    )
    wire = batch * 255
    got = UNetModel.infer_batch_device(on_card, wire).cpu()
    assert torch.equal(got, UNetModel.infer_batch_device(cpu, wire))  # a one-class softmax: all ones
    with torch.inference_mode():
        got_logits = on_card(torch.from_numpy(batch).to(card)).cpu()
        want_logits = cpu(torch.from_numpy(batch))
    assert float((got_logits - want_logits).abs().max()) <= LOGIT_TOL * float(want_logits.abs().max())


@pytest.mark.cuda
def test_grandqc_jpeg_golden_on_the_card_machine(card) -> None:  # noqa: ARG001
    """The card machine's build of the codec gives cv2's GrandQC round trip."""
    import chip_smoke

    assert chip_smoke.check_grandqc_golden() == {"cases": 4}
