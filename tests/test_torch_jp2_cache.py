"""The JP2 codestream's decoded-tile cache under concurrent readers.

A slide's patch loader reads from several threads through one
``J2KCodestream``, so its LRU is shared. The cache is made small enough
that every call evicts, and the interpreter switches threads as often as
it can, so that an unguarded cache is mutated while another thread walks
it. Every thread must get the tiles a lone decode gives.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.wsicore import jp2
from tiatoolbox_tpu_torch.wsicore.jp2 import J2KCodestream, encode_tiled_j2k

N_THREADS = 8
CALLS_PER_THREAD = 150


@pytest.fixture(scope="module")
def codestream_bytes() -> bytes:
    return encode_tiled_j2k(synthetic_he_patch((512, 384), seed=11), tile_size=64)


@pytest.mark.parametrize("reduce", [1, 2])
def test_shared_cache_under_threads(codestream_bytes, monkeypatch, reduce) -> None:
    alone = J2KCodestream.from_bytes(codestream_bytes)
    n_tiles = alone.grid_shape[0] * alone.grid_shape[1]
    want = alone.decode_tiles(list(range(n_tiles)), reduce)
    # room for about three tiles: nearly every call evicts
    monkeypatch.setattr(jp2, "TILE_CACHE_BYTES", 3 * want[0].nbytes)
    shared = J2KCodestream.from_bytes(codestream_bytes)
    errors: list[BaseException] = []
    wrong: list[tuple[int, int]] = []

    def reader(seed: int) -> None:
        rng = np.random.default_rng(seed)
        try:
            for _ in range(CALLS_PER_THREAD):
                indices = rng.choice(n_tiles, size=int(rng.integers(1, 5))).tolist()
                for index, tile in zip(indices, shared.decode_tiles(indices, reduce)):
                    if not np.array_equal(tile, want[index]):
                        wrong.append((seed, index))
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(seed,)) for seed in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, f"{len(errors)} readers raised, the first: {errors[0]!r}"
    assert not wrong, f"tiles differ from a lone decode: {wrong[:5]}"
    assert sum(v.nbytes for v in shared._cache()[0].values()) <= jp2.TILE_CACHE_BYTES
