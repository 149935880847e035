"""Stain augmentation: the port against the JAX package.

- ``stain_augment_reference`` (the plain version of the kernel ``K7`` that
  a CPU tensor runs) against ``augment_tiles_jax``: the factors and offsets
  are drawn in the test from the same ``jax.random`` key exactly as
  ``stainaugment.py:145-150`` draws them and passed to the port; the tiles
  must be within 1 uint8 level (float32 log/exp and summation order differ),
  for 2 and 3 stains;
- ``augment_tiles`` on the CPU: its draws from a seeded ``torch.Generator``
  reach the plain version, numpy tiles go to the requested device;
- ``StainAugmentor`` bit for bit with JAX's when both get
  ``np.random.default_rng(seed)``;
- ``augment_path``, the wrapper's choice between the kernel's tile-uniform
  and general paths, from the tiles' shape and start address.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.tools.stainaugment import StainAugmentor as JaxAugmentor
from tiatoolbox_tpu.tools.stainaugment import augment_tiles_jax
from tiatoolbox_tpu_torch.ops.stain import augment_path, stain_augment, stain_augment_reference
from tiatoolbox_tpu_torch.tools.stainaugment import StainAugmentor as PortAugmentor
from tiatoolbox_tpu_torch.tools.stainaugment import augment_tiles

HE = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
HED = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]])


def _tiles(seed: int, shape=(5, 24, 20, 3)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, shape, dtype=np.uint8)
    tiles[0, 0] = 0
    tiles[0, 1] = 255
    tiles[1:3] = synthetic_he_patch(shape[1:3][::-1], seed=seed)
    return tiles


def _jax_draws(key, n: int, s: int, sigma1: float, sigma2: float):
    k1, k2 = jax.random.split(key)
    alpha = jax.random.uniform(k1, (n, 1, 1, s), minval=1 - sigma1, maxval=1 + sigma1)
    beta = jax.random.uniform(k2, (n, 1, 1, s), minval=-sigma2, maxval=sigma2)
    return np.asarray(alpha).reshape(n, s), np.asarray(beta).reshape(n, s)


@pytest.mark.parametrize("stains", [HE, HED], ids=["2_stains", "3_stains"])
@pytest.mark.parametrize(("seed", "sigma1", "sigma2"), [(0, 0.4, 0.2), (1, 0.4, 0.2), (2, 0.9, 0.5), (3, 0.0, 0.0)])
def test_reference_against_augment_tiles_jax(stains, seed, sigma1, sigma2) -> None:
    tiles = _tiles(seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(augment_tiles_jax(tiles, stains, key, sigma1=sigma1, sigma2=sigma2))
    alpha, beta = _jax_draws(key, len(tiles), len(stains), sigma1, sigma2)
    proj = np.linalg.pinv(stains.T).T.astype(np.float32)
    got = stain_augment_reference(torch.from_numpy(tiles), proj, stains.astype(np.float32), alpha, beta)
    assert got.dtype == torch.uint8 and tuple(got.shape) == tiles.shape
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1
    if sigma1 > 0:
        assert (diff == 0).mean() >= 0.999
    # (with sigma 0 and 3 stains the tiles come back as they went in, each
    # value a float32 rounding away from an integer, and the truncation to
    # uint8 parts 8 % of them by a level)
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        stain_augment(torch.from_numpy(tiles), proj, stains, alpha, beta).numpy(), got.numpy()
    )


def test_augment_tiles_on_the_cpu() -> None:
    tiles = _tiles(4)
    gen = torch.Generator().manual_seed(7)
    got = augment_tiles(tiles, HE, generator=gen, device="cpu")
    gen = torch.Generator().manual_seed(7)
    alpha = torch.rand((5, 2), generator=gen) * 0.8 + 0.6
    beta = torch.rand((5, 2), generator=gen) * 0.4 - 0.2
    proj = np.linalg.pinv(HE.T).T.astype(np.float32)
    want = stain_augment_reference(torch.from_numpy(tiles), proj, HE.astype(np.float32), alpha, beta)
    assert torch.equal(got, want)
    assert float(alpha.min()) >= 0.6 and float(alpha.max()) < 1.4
    # a tensor stays where it is; sigma 0 leaves the concentrations as they were
    same = augment_tiles(torch.from_numpy(tiles), HED, sigma1=0.0, sigma2=0.0)
    unchanged = stain_augment_reference(torch.from_numpy(tiles), np.linalg.pinv(HED.T).T, HED, np.ones((5, 3)),
                                        np.zeros((5, 3)))
    assert torch.equal(same, unchanged)


@pytest.mark.parametrize(
    ("tiles", "stains", "alpha", "error"),
    [
        (np.zeros((2, 4, 4, 3), np.uint8), HE, np.ones((2, 2)), TypeError),
        (torch.zeros((2, 4, 4, 3)), HE, np.ones((2, 2)), ValueError),
        (torch.zeros((2, 4, 4, 4), dtype=torch.uint8), HE, np.ones((2, 2)), ValueError),
        (torch.zeros((2, 4, 4, 3), dtype=torch.uint8), HE[:1], np.ones((2, 1)), ValueError),
        (torch.zeros((2, 4, 4, 3), dtype=torch.uint8), np.ones((4, 3)), np.ones((2, 4)), ValueError),
        (torch.zeros((2, 4, 4, 3), dtype=torch.uint8), HE, np.ones((3, 2)), ValueError),
        (torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device="meta"), HE, np.ones((2, 2)), ValueError),
    ],
)
def test_stain_augment_rejects_bad_input(tiles, stains, alpha, error) -> None:
    proj = np.linalg.pinv(np.asarray(stains).T).T
    with pytest.raises(error):
        stain_augment(tiles, proj, stains, alpha, np.zeros_like(alpha))


@pytest.mark.parametrize(
    ("shape", "offset", "path"),
    [
        ((64, 224, 224, 3), 0, "tile_uniform"),  # phase A's batch: 3,136 chunks of 16 pixels a tile
        ((64, 224, 224, 3), 16, "tile_uniform"),  # a view one 16-byte word into a buffer
        ((64, 224, 224, 3), 3, "general"),  # not 16-byte aligned
        ((2, 16, 16, 3), 0, "tile_uniform"),
        ((45, 4, 4, 3), 0, "tile_uniform"),  # 16-pixel tiles
        ((21, 4, 12, 3), 0, "tile_uniform"),  # 48 pixels: a multiple of 16, not of 512
        ((7, 13, 11, 3), 0, "general"),  # 143 pixels a tile
        ((600, 1, 1, 3), 0, "general"),
        ((1, 513, 1, 3), 0, "general"),
    ],
)
def test_augment_path_choice(shape, offset, path) -> None:
    n = int(np.prod(shape))
    tiles = torch.zeros(n + 16, dtype=torch.uint8)[offset : offset + n].view(shape)
    assert tiles.data_ptr() % 16 == offset % 16
    assert augment_path(tiles) == path


def test_augment_path_takes_the_general_path_past_2_to_the_35_pixels() -> None:
    assert augment_path(torch.empty((2**27 - 1, 256, 1, 3), dtype=torch.uint8, device="meta")) == "tile_uniform"
    assert augment_path(torch.empty((2**27, 256, 1, 3), dtype=torch.uint8, device="meta")) == "general"


@pytest.mark.parametrize(
    ("method", "kwargs"),
    [
        ("macenko", {}),
        ("vahadane", {}),
        ("custom", {"stain_matrix": HE}),
        ("custom", {"stain_matrix": HED}),
        ("macenko", {"augment_background": True, "sigma1": 0.7, "sigma2": 0.1}),
    ],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_stain_augmentor_bit_for_bit(method, kwargs, seed) -> None:
    img = synthetic_he_patch((96, 80), seed=seed + 30)
    jax_aug = JaxAugmentor(method, **kwargs)
    port_aug = PortAugmentor(method, **kwargs)
    jax_aug.rng = np.random.default_rng(seed)
    port_aug.rng = np.random.default_rng(seed)
    jax_aug.fit(img)
    port_aug.fit(img)
    np.testing.assert_allclose(port_aug.stain_matrix, jax_aug.stain_matrix, rtol=0, atol=1e-12)
    for _ in range(3):
        np.testing.assert_array_equal(port_aug.augment(), jax_aug.augment())
    np.testing.assert_array_equal(port_aug.apply(img), jax_aug.apply(img))
    for _ in range(4):
        np.testing.assert_array_equal(port_aug(img)["image"], jax_aug(img)["image"])
    port_aug.get_params()
    jax_aug.get_params()
    assert (port_aug.alpha, port_aug.beta) == (jax_aug.alpha, jax_aug.beta)
    assert PortAugmentor.get_transform_init_args_names() == JaxAugmentor.get_transform_init_args_names()


def test_stain_augmentor_errors() -> None:
    for cls in (JaxAugmentor, PortAugmentor):
        with pytest.raises(ValueError, match="Unsupported stain extractor"):
            cls("ruifrok")
        with pytest.raises(ValueError, match="is None"):
            cls("custom")
    assert PortAugmentor("macenko", always_apply=True).p == 1.0
