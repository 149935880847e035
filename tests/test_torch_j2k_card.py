"""The JPEG 2000 codec's threaded decode on the card machine.

The codec is host C++ (``csrc/j2kdec.cpp``); these tests hold the card
machine's build of it (its compiler, its cores) to the golden set that
OpenCV made here (``tiatoolbox_tpu_torch/data/j2k_golden.npz``, pixels bit
for bit, the 9/7 streams too), and its threaded entries to one thread: a
tiled slide's tiles on every core, a single-tile image's code-blocks on
every core, a batch of TIFF-tile-like streams. They import the port only,
so they collect there; run them with
``python -m pytest -m cuda tests/test_torch_j2k_card.py``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.cuda


@pytest.fixture
def card_machine() -> int:
    if not torch.cuda.is_available():
        pytest.skip("needs the card machine; chip_smoke.py's jp2 phase runs these checks there")
    return os.cpu_count() or 1


def test_golden_set_on_the_card_machines_build(card_machine) -> None:
    import chip_smoke

    result = chip_smoke.check_j2k_golden()
    assert result["decode_cases"] >= 30 and result["reduced_cases"] == 3


def test_tiles_on_every_core_are_one_threads(card_machine) -> None:
    image = synthetic_he_patch((2048, 1536), seed=5)
    stream = native.encode_j2k(image, 256, n_threads=card_machine)
    n = native.j2k_header(stream)["tiles_across"] * native.j2k_header(stream)["tiles_down"]
    one = native.decode_j2k_tiles(stream, range(n), n_threads=1)
    many = native.decode_j2k_tiles(stream, range(n), n_threads=card_machine)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.decode_j2k(stream, n_threads=card_machine), image)


def test_code_blocks_on_every_core_are_one_threads(card_machine) -> None:
    image = synthetic_he_patch((1024, 768), seed=6)
    for opts in ({}, {"irreversible": True, "layers": 3, "cblk_style": ("bypass", "termall")}):
        stream = native.encode_j2k(image, **opts)
        np.testing.assert_array_equal(
            native.decode_j2k(stream, n_threads=card_machine), native.decode_j2k(stream, n_threads=1)
        )


def test_batch_on_every_core_is_one_threads(card_machine) -> None:
    rng = np.random.default_rng(7)
    tiles = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(3 * card_machine)]
    streams = [native.encode_j2k(t, n_threads=1) for t in tiles]
    for got, want in zip(native.decode_j2k_batch(streams, n_threads=card_machine), tiles):
        np.testing.assert_array_equal(got, want)
