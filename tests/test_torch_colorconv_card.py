"""K8 (the yuv420 unpack, ``csrc/colorconv.cu``) and the data mesh on the card.

These tests import the port only (the card machine has no flax). K8 is held
against its plain version bit for bit: the batch entry in float32 with and
without the division by 255 and in bfloat16, over every (Y, Cb, Cr) triple,
and the band entry at full size, cropped and ragged. The edges of the
strip design: rows that start off a 16-byte boundary (widths 226, 2050,
6874), band crops with an odd width below the planes', batches of 1 and 65
images, an image smaller than a strip (4x2), and planes that are a view at
a 2-byte offset, each bit for bit and counted as one launch. A mesh of two replicas
on ``cuda:0`` (``mesh.local_devices`` replaced) is held against one device
within 1e-5, TF32 off. Each test skips without a card; run them there with
``python -m pytest -m cuda tests/test_torch_colorconv_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
from tiatoolbox_tpu_torch.ops import colorconv
from tiatoolbox_tpu_torch.parallel import mesh


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's wire and dp phases run these checks on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def every_triple() -> np.ndarray:
    """Planes ``[64, 192, 2048]``: each image's chroma holds all 65,536 (Cb, Cr)
    pairs, and image k's 2x2 blocks hold luma 4k to 4k + 3, so every (Y, Cb, Cr)
    triple occurs."""
    h, w = 128, 2048
    pairs = np.arange(1 << 16)
    planes = np.empty((64, h + h // 2, w), np.uint8)
    offset = (np.arange(h)[:, None] % 2) * 2 + np.arange(w)[None, :] % 2
    for k in range(64):
        planes[k, :h] = 4 * k + offset
    planes[:, h : h + h // 4] = (pairs & 255).astype(np.uint8).reshape(h // 4, w)
    planes[:, h + h // 4 :] = (pairs >> 8).astype(np.uint8).reshape(h // 4, w)
    return planes


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("dtype", "scale"), [(torch.float32, False), (torch.float32, True), (torch.bfloat16, True)],
    ids=["float32", "float32_div255", "bfloat16_div255"],
)
def test_batch_entry_matches_plain_version_on_every_triple(card, dtype, scale: bool) -> None:
    planes = torch.from_numpy(every_triple())
    want = colorconv.yuv420_batch_to_rgb_reference(planes, dtype, scale=scale)
    before = colorconv.yuv420_to_rgb.launches
    got = colorconv.yuv420_batch_to_rgb(planes.to(card), dtype, scale=scale)
    torch.cuda.synchronize()
    assert colorconv.yuv420_to_rgb.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous() and tuple(got.shape) == (64, 128, 2048, 3)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("band_hw", [(128, 2048), (125, 2047), (1, 1)])
def test_band_entry_matches_plain_version(card, band_hw) -> None:
    planes = torch.from_numpy(every_triple()[5])
    got = colorconv.unpack_yuv420_band(planes.to(card), band_hw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), colorconv.unpack_yuv420_band_reference(planes, band_hw))


@pytest.mark.cuda
@pytest.mark.parametrize("size_wh", [(113, 70), (6874, 1474)])
def test_band_entry_on_packed_bands(card, size_wh) -> None:
    image = synthetic_he_patch(size_wh, seed=3)
    planes = torch.from_numpy(colorconv.rgb_image_to_yuv420(image))
    got = colorconv.unpack_yuv420_band(planes.to(card), image.shape[:2])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), colorconv.unpack_yuv420_band_reference(planes, image.shape[:2]))
    assert np.abs(got.cpu().numpy().astype(int) - image.astype(int)).mean() < 4.0


def random_planes(n: int, h: int, w: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, h * 3 // 2, w), dtype=np.uint8))


def held(planes: torch.Tensor, card, dtype=torch.float32, band_hw=None) -> None:
    """One launch of K8 on ``planes`` equals the plain version bit for bit."""
    before = colorconv.yuv420_to_rgb.launches
    if band_hw is None:
        want = colorconv.yuv420_batch_to_rgb_reference(planes, dtype, scale=True)
        got = colorconv.yuv420_to_rgb(planes.to(card), dtype, scale=True)
    else:
        want = colorconv.unpack_yuv420_band_reference(planes, band_hw)
        got = colorconv.yuv420_to_rgb(planes.to(card), band_hw=band_hw)
    torch.cuda.synchronize()
    assert colorconv.yuv420_to_rgb.launches == before + 1
    assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("w", [226, 2050, 6874])
def test_batch_rows_off_16_byte_boundaries(card, w: int, dtype) -> None:
    held(random_planes(3, 12, w, seed=w), card, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("band_hw", [(11, 2047), (9, 2049), (12, 1001), (1, 3)])
def test_band_crop_odd_width_below_the_planes(card, band_hw) -> None:
    held(random_planes(1, 12, 2050, seed=band_hw[1])[0], card, band_hw=band_hw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 65])
def test_batch_of_one_and_of_65(card, n: int, dtype) -> None:
    held(random_planes(n, 224, 224, seed=n), card, dtype)


@pytest.mark.cuda
def test_image_smaller_than_a_strip(card) -> None:
    planes = random_planes(1, 4, 2, seed=4)
    held(planes, card, torch.float32)
    held(planes, card, torch.bfloat16)
    held(planes[0], card, band_hw=(4, 2))
    held(planes[0], card, band_hw=(3, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 226), (1, 1476, 6874)], ids=["batch", "band"])
def test_planes_at_a_2_byte_offset(card, shape) -> None:
    n, h, w = shape
    size = n * h * 3 // 2 * w
    storage = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size + 16, dtype=np.uint8)).to(card)
    planes = storage[2 : 2 + size].view(n, h * 3 // 2, w)
    assert planes.is_contiguous() and planes.data_ptr() % 16 == 2
    before = colorconv.yuv420_to_rgb.launches
    if n > 1:
        got = colorconv.yuv420_to_rgb(planes, torch.float32, scale=True)
        want = colorconv.yuv420_batch_to_rgb_reference(planes.cpu(), torch.float32, scale=True)
    else:
        got = colorconv.yuv420_to_rgb(planes[0], band_hw=(h - 1, w - 1))
        want = colorconv.unpack_yuv420_band_reference(planes[0].cpu(), (h - 1, w - 1))
    torch.cuda.synchronize()
    assert colorconv.yuv420_to_rgb.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card) -> None:
    with pytest.raises(ValueError, match="yuv420"):
        colorconv.yuv420_to_rgb(torch.zeros((1, 45, 30), dtype=torch.uint8, device=card))
    with pytest.raises(ValueError, match="uint8"):
        colorconv.yuv420_to_rgb(torch.zeros((1, 48, 32), dtype=torch.float32, device=card))
    with pytest.raises(ValueError, match="exceeds"):
        colorconv.yuv420_to_rgb(torch.zeros((48, 32), dtype=torch.uint8, device=card), band_hw=(33, 32))


@pytest.mark.cuda
def test_two_replicas_on_one_card_match_one_device(card, monkeypatch) -> None:
    card = torch.device("cuda", 0)
    monkeypatch.setattr(mesh, "local_devices", lambda: [card, card])
    model = CNNModel("resnet18", num_classes=9, device=card)
    batch = np.random.default_rng(0).integers(0, 256, (13, 224, 224, 3), dtype=np.uint8)
    single = CNNModel.infer_batch(model, batch)
    model.enable_data_parallel()
    assert model.mesh.size == 2 and model.device == card
    np.testing.assert_allclose(CNNModel.infer_batch(model, batch), single, atol=1e-5, rtol=0)
    model.wire_format = "yuv420"
    planes = model.stage_batch(batch)
    assert planes.ndim == 3 and planes.device == card
    dp = CNNModel.infer_batch(model, planes)
    model.mesh = None
    np.testing.assert_allclose(dp, CNNModel.infer_batch(model, planes), atol=1e-5, rtol=0)
