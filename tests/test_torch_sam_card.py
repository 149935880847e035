"""SAM on the card against the CPU, at a tiny width.

The tiny checkpoint is written by the port's own writer (no transformers
or JAX here: the card machine has neither). The uint8 resample and the
pre-processing give the CPU's values bit for bit on the card; the
low-resolution logits and IoU scores agree within 1e-4 with TF32 off, at
least 99.9 % of the mask pixels agree, the encoder's batch gives the
per-image embeddings, and PromptSegmentor writes stores with the CPU's
annotation counts. Run them there with
``python -m pytest -m cuda tests/test_torch_sam_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore
from tiatoolbox_tpu_torch.models.architecture.sam import SAM, save_sam_checkpoint, seeded_sam_state
from tiatoolbox_tpu_torch.models.architecture.sam_config import (
    PreprocessorConfig,
    SamConfig,
    SamMaskDecoderConfig,
    SamPromptEncoderConfig,
    SamVisionConfig,
)
from tiatoolbox_tpu_torch.models.architecture.sam_processor import preprocess, resize_bilinear_u8
from tiatoolbox_tpu_torch.models.engine import PromptSegmentor

pytestmark = pytest.mark.cuda

TINY = SamConfig(
    SamVisionConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, global_attn_indexes=(1,),
                    window_size=4, image_size=160, output_channels=32, num_pos_feats=16),
    SamPromptEncoderConfig(hidden_size=32, image_size=160),
    SamMaskDecoderConfig(hidden_size=32, mlp_dim=64, num_attention_heads=2, iou_head_hidden_dim=32),
)
PRE = PreprocessorConfig(longest_edge=160, pad_height=160, pad_width=160)
PROMPTS = {
    "points": {"point_coords": [[[30, 40], [80, 25]]]},
    "box": {"box_coords": np.array([[[10, 15, 90, 100]]])},
    "point_box": {"point_coords": [[[50, 50]]], "box_coords": [[[20, 20, 100, 90]]]},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card; chip_smoke.py's sam phase runs these checks there at full width")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.fixture
def sams(card, tmp_path):
    directory = save_sam_checkpoint(tmp_path / "tiny", seeded_sam_state(TINY, seed=3), TINY, PRE)
    return SAM(directory, device=card), SAM(directory, device="cpu")


@pytest.mark.parametrize("hw_in, hw_out", [((300, 211), (37, 59)), ((37, 59), (211, 300)), ((1500, 1000), (1024, 683)), ((1, 9), (7, 1))])
def test_resample_and_preprocess_bit_for_bit(card, hw_in, hw_out) -> None:
    image = torch.from_numpy(np.random.default_rng(hw_in[0]).integers(0, 256, (*hw_in, 3), dtype=np.uint8))
    assert torch.equal(resize_bilinear_u8(image.to(card), hw_out).cpu(), resize_bilinear_u8(image, hw_out))
    got, _, _ = preprocess(image.numpy(), PreprocessorConfig(), card)
    want, _, _ = preprocess(image.numpy(), PreprocessorConfig(), "cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("hw", [(120, 90), (300, 200)])
@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_logits_and_masks_against_the_cpu(sams, hw, prompt) -> None:
    on_card, on_cpu = sams
    image = np.random.default_rng(sum(hw)).integers(0, 256, (1, *hw, 3), dtype=np.uint8)
    got = on_card.infer_logits(image, **PROMPTS[prompt])[0]
    want = on_cpu.infer_logits(image, **PROMPTS[prompt])[0]
    np.testing.assert_allclose(got["low_res_masks"].cpu().numpy(), want["low_res_masks"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["iou_scores"].cpu().numpy(), want["iou_scores"].numpy(), rtol=0, atol=1e-4)
    masks = on_card.infer_batch(image, **PROMPTS[prompt])[0]
    assert masks.shape == (3, *hw) and masks.dtype == bool
    assert (masks == on_cpu.infer_batch(image, **PROMPTS[prompt])[0]).mean() >= 0.999


def test_encoder_batch_equals_single_images(sams) -> None:
    on_card, _ = sams
    images = np.random.default_rng(9).integers(0, 256, (6, 100, 150, 3), dtype=np.uint8)
    batch, _, _ = on_card.encode(images)
    for i, image in enumerate(images):
        single, _, _ = on_card.encode(image[None])
        torch.testing.assert_close(batch[i : i + 1], single, rtol=0, atol=1e-5)


def test_prompt_segmentor_on_the_card(sams, tmp_path) -> None:
    on_card, on_cpu = sams
    images = list(np.random.default_rng(10).integers(0, 256, (2, 160, 160, 3), dtype=np.uint8))
    prompts = {"point_coords": np.array([[[40, 50]], [[90, 60]]]), "box_coords": np.array([[[15, 10, 110, 90]], [[30, 20, 140, 95]]])}
    got = PromptSegmentor(model=on_card).run(images, save_dir=tmp_path / "card", device="cuda", **prompts)
    want = PromptSegmentor(model=on_cpu).run(images, save_dir=tmp_path / "cpu", device="cpu", **prompts)
    assert on_card.device.type == "cuda"
    assert [len(SQLiteStore(p)) for p in got] == [len(SQLiteStore(p)) for p in want]
