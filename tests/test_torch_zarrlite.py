"""The port's zarr store against JAX's (``utils/zarrlite.py``).

The same seeded assignments go into an array of each package; reads and
the files on disk (``.zarray`` and every chunk) must be identical, a store
written by either package must read the same in the other, and
``create_smart_array`` must spill only above its threshold and only with a
``save_dir``.
"""

from __future__ import annotations

import numpy as np
import pytest

from tiatoolbox_tpu.utils import zarrlite as jz
from tiatoolbox_tpu_torch.utils import zarrlite as pz

DTYPES = ["uint8", "int16", "int32", "int64", "float16", "float32", "float64", "bool"]


def _same_files(a, b) -> None:
    names_a = sorted(p.name for p in a.iterdir())
    names_b = sorted(p.name for p in b.iterdir())
    assert names_a == names_b
    for name in names_a:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _random_key(rng, shape):
    key = []
    for n in shape:
        if rng.random() < 0.2:
            key.append(int(rng.integers(-n, n)))
        else:
            a, b = sorted(rng.integers(0, n + 1, 2))
            key.append(slice(int(a), int(b) + (a == b)))
    return tuple(key)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("compress", [True, False])
def test_assignments_and_reads_match_jax(tmp_path, dtype: str, compress: bool) -> None:
    rng = np.random.default_rng(7)
    shape, chunks = (37, 23, 3), (8, 10, 3)
    arrays = [
        mod.ZarrArray.create(tmp_path / name, shape, chunks=chunks, dtype=dtype, compress=compress)
        for mod, name in ((jz, "jax.zarr"), (pz, "port.zarr"))
    ]
    for step in range(25):
        key = _random_key(rng, shape)
        # an integer index keeps its axis, of length 1, on assignment
        sel = tuple(1 if isinstance(k, int) else len(range(n)[k]) for k, n in zip(key, shape))
        value = rng.integers(0, 100, sel) if step % 5 else rng.integers(0, 100)
        for arr in arrays:
            arr[key] = np.asarray(value).astype(dtype)
        read_key = _random_key(rng, shape)
        np.testing.assert_array_equal(arrays[1][read_key], arrays[0][read_key])
    np.testing.assert_array_equal(np.asarray(arrays[1]), np.asarray(arrays[0]))
    _same_files(tmp_path / "jax.zarr", tmp_path / "port.zarr")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_read_the_same_in_both_packages(tmp_path, writer: str) -> None:
    rng = np.random.default_rng(11)
    src, dst = (jz, pz) if writer == "jax" else (pz, jz)
    data = rng.random((130, 70, 5)).astype(np.float32)
    labels = rng.integers(0, 255, (130, 70), dtype=np.uint8)
    group = src.ZarrGroup.create(tmp_path / "out.zarr")
    group.from_array("probabilities", data)
    group.from_array("predictions", labels, chunks=(32, 32))
    group.attrs = {"names": ["a", "b"], "n": 3}
    sub = group.create_group("extra")
    sub.create_array("empty", shape=(10, 4), dtype=np.int32, fill_value=0)

    opened = dst.open_zarr(tmp_path / "out.zarr")
    assert isinstance(opened, dst.ZarrGroup)
    assert opened.keys() == ["extra", "predictions", "probabilities"]
    assert opened.attrs == {"names": ["a", "b"], "n": 3}
    np.testing.assert_array_equal(np.asarray(opened["probabilities"]), data)
    np.testing.assert_array_equal(opened["predictions"][5:100, 3], labels[5:100, 3])
    assert opened["predictions"].chunks == (32, 32)
    np.testing.assert_array_equal(np.asarray(opened["extra"]["empty"]), np.zeros((10, 4), np.int32))
    # a member written by the other package lands in the same group
    opened.from_array("more", labels[:7])
    np.testing.assert_array_equal(np.asarray(src.open_zarr(tmp_path / "out.zarr")["more"]), labels[:7])


@pytest.mark.parametrize(
    "shape,dtype",
    [((4608, 6144, 5), np.float32), ((3072, 4100, 1), np.float32), ((100, 3), np.uint8), ((5,), np.int64)],
)
def test_default_chunks_match_jax(shape, dtype) -> None:
    assert pz._default_chunks(shape, np.dtype(dtype)) == jz._default_chunks(shape, np.dtype(dtype))


@pytest.mark.parametrize("save_dir", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 1.0])
def test_create_smart_array_spills_only_above_threshold_with_a_save_dir(
    tmp_path, monkeypatch, save_dir: bool, threshold: float
) -> None:
    monkeypatch.setattr(pz, "free_ram_bytes", lambda: 10_000)
    monkeypatch.setattr(jz, "free_ram_bytes", lambda: 10_000)
    shape = (50, 40, 2)  # 16,000 bytes of float32: over 1.0 of 10,000 too
    small = (10, 10, 2)
    for mod, name in ((pz, "port"), (jz, "jax")):
        target = tmp_path / name if save_dir else None
        big = mod.create_smart_array(shape, np.float32, save_dir=target, memory_fraction=threshold, name="c")
        fits = mod.create_smart_array(small, np.float32, save_dir=target, memory_fraction=1.0, name="s")
        assert isinstance(fits, np.ndarray)
        if save_dir:
            assert type(big).__name__ == "ZarrArray" and big.path == tmp_path / name / "c.zarr"
        else:
            assert isinstance(big, np.ndarray)
        assert big.shape == shape and float(np.asarray(big).max()) == 0.0
    if save_dir:
        _same_files(tmp_path / "jax" / "c.zarr", tmp_path / "port" / "c.zarr")


def test_free_ram_bytes_reads_meminfo() -> None:
    # both read MemAvailable, which moves between the two reads
    assert pz.free_ram_bytes() > 0
    assert abs(pz.free_ram_bytes() - jz.free_ram_bytes()) < 1 << 30
