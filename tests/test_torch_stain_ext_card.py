"""The stain augmentation kernel (K7, ``csrc/stain.cu`` ``stain_augment_u8``) on the card.

These tests import the port only, so they collect on the card machine too.
K7 is held against its plain version (``stain_augment_reference``) at most
1 uint8 level apart and at least 99.9 % identical, for 2 and 3 stains, at
the main path's batch, on ragged pixel counts around its 16- and 512-pixel
steps, with tiles whose byte size is no multiple of 16, on a view 3 bytes
into a buffer, and over all 2^24 colours. Its tile-uniform path is held
against its general path bit for bit on the same pixels (a batch, and the
same batch as a view 3 bytes into a buffer) at the main path's batch and
at the tile-uniform path's edges: tiles of 16, 48 and 512 pixels, with
chunks past the last 512-pixel step, 224^2 with N = 1 and N = 65, 256^2.
The entry refuses the tile-uniform path where its conditions do not hold.
``augment_tiles`` on a CUDA tensor raises where the kernel cannot be built
or launched: it never gives way to the plain version. They skip without a
card; run them there with
``python -m pytest -m cuda tests/test_torch_stain_ext_card.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch.ops import stain as stain_ops
from tiatoolbox_tpu_torch.tools.stainaugment import augment_tiles

pytestmark = pytest.mark.cuda

HE = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]], np.float32)
HED = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]], np.float32)
SHAPES = [(64, 224, 224, 3), (1, 1, 1, 3), (3, 5, 7, 3), (7, 13, 11, 3), (600, 1, 1, 3), (2, 16, 16, 3),
          (33, 17, 31, 3), (1, 513, 1, 3)]
# tiles of 224^2, 16, 48 and 512 pixels (45 and 63 chunks of 16: one warp-step
# and a tail), 224^2 with N = 1 and 65, 256^2
UNIFORM_SHAPES = [(64, 224, 224, 3), (45, 4, 4, 3), (21, 4, 12, 3), (37, 16, 32, 3), (1, 224, 224, 3),
                  (65, 224, 224, 3), (5, 256, 256, 3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py's stain_ext phase runs these checks on the card")
    return torch.device("cuda")


def _args(tiles: torch.Tensor, stains: np.ndarray, gen: torch.Generator) -> tuple:
    n, s = tiles.shape[0], stains.shape[0]
    alpha = torch.rand((n, s), generator=gen, device=tiles.device) * 0.8 + 0.6
    beta = torch.rand((n, s), generator=gen, device=tiles.device) * 0.4 - 0.2
    proj = np.linalg.pinv(stains.T).T.astype(np.float32)
    return proj, stains, alpha, beta


def _held(tiles: torch.Tensor, stains: np.ndarray, gen: torch.Generator, args=None) -> torch.Tensor:
    args = _args(tiles, stains, gen) if args is None else args
    before = stain_ops.stain_augment.launches
    got = stain_ops.stain_augment(tiles, *args)
    assert stain_ops.stain_augment.launches == before + 1
    want = stain_ops.stain_augment_reference(tiles, *args)
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).double().mean()) >= 0.999
    return got


def _misaligned(tiles: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(3 + tiles.numel(), dtype=torch.uint8, device=tiles.device)
    buf[3:] = tiles.flatten()
    return buf[3:].view(tiles.shape)


@pytest.mark.parametrize("stains", [HE, HED], ids=["2_stains", "3_stains"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k7_against_plain(card, stains, shape) -> None:
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    rng = np.random.default_rng(sum(shape))
    tiles = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(card)
    _held(tiles, stains, gen)
    misaligned = _misaligned(tiles)
    assert misaligned.data_ptr() % 16 != 0
    _held(misaligned, stains, gen)


@pytest.mark.parametrize("stains", [HE, HED], ids=["2_stains", "3_stains"])
@pytest.mark.parametrize("shape", UNIFORM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k7_tile_uniform_against_general(card, stains, shape) -> None:
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    tiles = torch.from_numpy(np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)).to(card)
    view = _misaligned(tiles)
    assert stain_ops.augment_path(tiles) == "tile_uniform" and stain_ops.augment_path(view) == "general"
    args = _args(tiles, stains, gen)
    assert torch.equal(_held(tiles, stains, gen, args), _held(view, stains, gen, args))


def test_k7_entry_refuses_tile_uniform_where_it_cannot_run(card) -> None:
    lib = stain_ops._library()
    args = _args(torch.zeros((2, 16, 16, 3), dtype=torch.uint8), HE, torch.Generator().manual_seed(0))
    alpha, beta = args[2].to(card), args[3].to(card)
    coefs = stain_ops.augment_coefs(args[0], HE)
    stream = torch.cuda.current_stream(card).cuda_stream
    for shape, offset in (((2, 16, 16, 3), 3), ((2, 5, 7, 3), 0)):
        n_pix = int(np.prod(shape[:-1]))
        buf = torch.zeros(3 * n_pix + 16, dtype=torch.uint8, device=card)
        tiles = buf[offset : offset + 3 * n_pix]
        out = torch.empty(3 * n_pix, dtype=torch.uint8, device=card)
        code = lib.stain_augment_u8(tiles.data_ptr(), out.data_ptr(), n_pix, n_pix // 2, 2, 1, alpha.data_ptr(),
                                    beta.data_ptr(), coefs, stream)
        assert code == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("stains", [HE, HED], ids=["2_stains", "3_stains"])
def test_k7_every_colour(card, stains) -> None:
    c = torch.arange(1 << 24, dtype=torch.int32, device=card)
    colours = torch.stack([c >> 16, (c >> 8) & 255, c & 255], -1).to(torch.uint8).reshape(256, 256, 256, 3)
    _held(colours, stains, torch.Generator(device=card).manual_seed(1))


def test_augment_tiles_seeded_on_the_card(card) -> None:
    tiles = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)).to(card)
    first = augment_tiles(tiles, HE, generator=torch.Generator(device=card).manual_seed(5))
    again = augment_tiles(tiles, HE, generator=torch.Generator(device=card).manual_seed(5))
    assert first.device.type == "cuda" and torch.equal(first, again)
    on_card = augment_tiles(tiles.cpu().numpy(), HE, generator=torch.Generator(device=card).manual_seed(5))
    assert torch.equal(on_card, first)


def test_augment_tiles_raises_instead_of_falling_back(card, monkeypatch) -> None:
    tiles = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=card)

    def no_library():
        raise RuntimeError("nvcc failed to build stain.cu")

    monkeypatch.setattr(stain_ops, "_library", no_library)
    before = stain_ops.stain_augment.launches
    with pytest.raises(RuntimeError, match="failed to build"):
        augment_tiles(tiles, HE, generator=torch.Generator(device=card))

    class FailingLibrary:
        @staticmethod
        def stain_augment_u8(*_args):
            return 98  # cudaErrorInvalidDeviceFunction

        @staticmethod
        def stain_error_string(_code):
            return b"invalid device function"

    monkeypatch.setattr(stain_ops, "_library", lambda: FailingLibrary)
    with pytest.raises(RuntimeError, match="stain_augment_u8 failed"):
        augment_tiles(tiles, HE, generator=torch.Generator(device=card))
    assert stain_ops.stain_augment.launches == before
