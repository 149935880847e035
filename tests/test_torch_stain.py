"""Stain normalisation: the port (``tiatoolbox_tpu_torch``) against the JAX package.

The port's plain stain transform (what a CPU tensor runs) is held against
JAX ``stain_transform`` (``ops/stain.py:35``) and against the JAX package's
own Pallas kernel body ``_stain_kernel`` run in interpret mode. Tolerance:
uint8 max abs difference 1 and at least 99.9 % identical values (float32
log/exp and summation order differ between the two frameworks). The host
float64 stain estimation is held to rtol 1e-6.
"""

from __future__ import annotations

import contextlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.ops.stain import _stain_kernel
from tiatoolbox_tpu.ops.stain import stain_transform as jax_stain_transform
from tiatoolbox_tpu.tools import stainnorm as jax_stainnorm
from tiatoolbox_tpu.tools.stainextract import MacenkoExtractor as JaxMacenko
from tiatoolbox_tpu.utils import misc as jax_misc
from tiatoolbox_tpu_torch import _build, resolve_device
from tiatoolbox_tpu_torch.ops import stain as port_stain
from tiatoolbox_tpu_torch.tools import stainnorm as port_stainnorm
from tiatoolbox_tpu_torch.tools.stainextract import MacenkoExtractor as PortMacenko
from tiatoolbox_tpu_torch.utils import misc as port_misc


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiles(seed: int, shape=(4, 32, 32, 3)) -> np.ndarray:
    """Random uint8 tiles with black pixels and saturated white rows."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, shape, dtype=np.uint8)
    tiles[0, 0] = 0
    tiles[0, 1] = 255
    tiles[1, :4] = rng.integers(0, 3, (4, shape[2], 3), dtype=np.uint8)
    return tiles


def _constants(seed: int) -> dict:
    norm = jax_stainnorm.get_normalizer("macenko")
    norm.fit(synthetic_he_patch((96, 96), seed=seed))
    return norm.prepare_tile_transform(synthetic_he_patch((96, 96), seed=seed + 1))


# Pixel counts around the CUDA kernel's 16-pixel lane step and 512-pixel
# warp step (and one main-path batch of 64x224x224 plus 5), and a contiguous
# view 3 bytes into a buffer, which the kernel cannot read with 16-byte vectors.
_RAGGED_PIXELS = {f"{n}_pixels": n for n in (1, 15, 16, 17, 511, 512, 513)}
RAGGED_CASES = [*_RAGGED_PIXELS, "batch_plus_5_pixels", "view_3_bytes_in"]


def _ragged(case: str, device: str = "cpu") -> torch.Tensor:
    """The uint8 ``[n, 3]`` input of a ragged or misaligned case on ``device``."""
    rng = np.random.default_rng(RAGGED_CASES.index(case))
    if case == "view_3_bytes_in":
        buf = torch.from_numpy(rng.integers(0, 256, 3 + 3 * 4099, dtype=np.uint8)).to(device)
        return buf[3:].view(-1, 3)
    n = _RAGGED_PIXELS.get(case, 64 * 224 * 224 + 5)
    return torch.from_numpy(rng.integers(0, 256, (n, 3), dtype=np.uint8)).to(device)


def _assert_u8_close(a: np.ndarray, b: np.ndarray) -> None:
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert a.shape == b.shape
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999


@contextlib.contextmanager
def _without_import_stubs():
    """Hide another test module's stub importer while importing pallas.

    ``tests/ref_compat.py`` installs a ``sys.meta_path`` finder that turns
    missing packages into permissive stub modules. JAX's optional GPU
    extension then imports as a stub instead of failing, and
    ``jax.experimental.pallas`` cannot load. Remove the finder and its stub
    modules for the import, and put both back afterwards.
    """
    finders = [f for f in sys.meta_path if type(f).__name__ == "_StubFinder"]
    stubs = {k: m for k, m in sys.modules.items() if type(m).__name__ == "_AnyAttrModule"}
    for finder in finders:
        sys.meta_path.remove(finder)
    for name in stubs:
        del sys.modules[name]
    try:
        yield
    finally:
        sys.meta_path.extend(finders)
        for name, module in stubs.items():
            sys.modules.setdefault(name, module)


def _pallas_interpret(tiles: np.ndarray, c: dict) -> np.ndarray:
    """The JAX package's ``_stain_kernel`` through a plain interpreted pallas_call."""
    with _without_import_stubs():
        from jax.experimental import pallas as pl

    flat = tiles.reshape(-1, 3)
    lanes, block_rows = 128, 8
    rows = -(-flat.shape[0] // (lanes * block_rows)) * block_rows
    padded = np.zeros((rows * lanes, 3), np.uint8)
    padded[: len(flat)] = flat
    planes = [jnp.asarray(padded[:, k].reshape(rows, lanes)) for k in range(3)]
    coefs = np.zeros((1, 16), np.float32)
    coefs[0, 0:6] = np.asarray(c["conc_proj"], np.float32).reshape(-1)
    coefs[0, 6:8] = np.asarray(c["conc_scale"], np.float32).reshape(-1)
    coefs[0, 8:14] = np.asarray(c["target_stains"], np.float32).reshape(-1)
    spec = pl.BlockSpec((block_rows, lanes), lambda i: (i, 0))
    out_shape = jnp.zeros((rows, lanes), jnp.uint8)
    outs = pl.pallas_call(
        _stain_kernel,
        grid=(rows // block_rows,),
        in_specs=[spec, spec, spec, pl.BlockSpec((1, 16), lambda i: (0, 0))],
        out_specs=(spec, spec, spec),
        out_shape=(out_shape, out_shape, out_shape),
        interpret=True,
    )(*planes, jnp.asarray(coefs))
    out = np.stack([np.asarray(o).reshape(-1) for o in outs], axis=-1)
    return out[: len(flat)].reshape(tiles.shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_matches_jax_stain_transform(seed: int) -> None:
    tiles, c = _tiles(seed), _constants(seed)
    want = np.asarray(
        jax_stain_transform(
            jnp.asarray(tiles),
            jnp.asarray(c["conc_proj"]),
            jnp.asarray(c["target_stains"]),
            jnp.asarray(c["conc_scale"]),
        )
    )
    got = port_stain.stain_transform(
        torch.from_numpy(tiles), c["conc_proj"], c["target_stains"], c["conc_scale"]
    )
    _assert_u8_close(got.numpy(), want)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_and_misaligned_inputs_match_jax_on_cpu(case: str) -> None:
    tiles, c = _ragged(case), _constants(8)
    assert tiles.is_contiguous()
    if case == "view_3_bytes_in":
        assert tiles.storage_offset() == 3
    want = np.asarray(
        jax_stain_transform(
            jnp.asarray(tiles.numpy()),
            jnp.asarray(c["conc_proj"]),
            jnp.asarray(c["target_stains"]),
            jnp.asarray(c["conc_scale"]),
        )
    )
    got = port_stain.stain_transform(tiles, c["conc_proj"], c["target_stains"], c["conc_scale"])
    _assert_u8_close(got.numpy(), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_version_matches_pallas_kernel_body(seed: int) -> None:
    tiles, c = _tiles(seed, (2, 24, 40, 3)), _constants(seed)
    want = _pallas_interpret(tiles, c)
    got = port_stain.stain_transform_reference(
        torch.from_numpy(tiles), c["conc_proj"], c["target_stains"], c["conc_scale"]
    )
    _assert_u8_close(got.numpy(), want)


@pytest.mark.parametrize("seed", [5, 6])
def test_macenko_and_tile_constants_match_jax(seed: int) -> None:
    target = synthetic_he_patch((128, 96), seed=seed)
    source = synthetic_he_patch((96, 128), seed=seed + 10)
    np.testing.assert_allclose(
        PortMacenko().get_stain_matrix(target),
        JaxMacenko().get_stain_matrix(target),
        rtol=1e-6,
    )
    jax_norm = jax_stainnorm.get_normalizer("macenko")
    port_norm = port_stainnorm.get_normalizer("macenko")
    jax_norm.fit(target)
    port_norm.fit(target)
    want = jax_norm.prepare_tile_transform(source)
    got = port_norm.prepare_tile_transform(source)
    for key in ("conc_proj", "target_stains", "conc_scale"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    np.testing.assert_array_equal(port_norm.transform(source), jax_norm.transform(source))


@pytest.mark.parametrize("method", ["ruifrok", "custom"])
def test_fixed_matrix_normalizers_match_jax(method: str) -> None:
    kwargs = {"stain_matrix": np.array([[0.6, 0.75, 0.28], [0.1, 0.95, 0.2]])} if method == "custom" else {}
    target = synthetic_he_patch((64, 64), seed=8)
    source = synthetic_he_patch((64, 64), seed=9)
    jax_norm = jax_stainnorm.get_normalizer(method, **kwargs)
    port_norm = port_stainnorm.get_normalizer(method, **kwargs)
    jax_norm.fit(target)
    port_norm.fit(target)
    np.testing.assert_array_equal(port_norm.transform(source), jax_norm.transform(source))


def test_luminosity_tissue_mask_matches_jax() -> None:
    img = synthetic_he_patch((160, 120), seed=12)
    np.testing.assert_array_equal(
        port_misc.get_luminosity_tissue_mask(img, 0.8),
        jax_misc.get_luminosity_tissue_mask(img, 0.8),
    )


def test_lab_luminosity_and_grey_are_opencv_exact() -> None:
    import cv2

    colors = np.arange(1 << 24, dtype=np.uint32)
    for chunk in np.array_split(colors, 8):
        rgb = np.stack([(chunk >> 16) & 255, (chunk >> 8) & 255, chunk & 255], -1)
        img = rgb.astype(np.uint8).reshape(1, -1, 3)
        np.testing.assert_array_equal(
            port_misc.lab_luminosity_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2LAB)[..., 0]
        )
        np.testing.assert_array_equal(
            port_misc.rgb2gray_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        )


def test_transform_tiles_on_cpu_matches_jax() -> None:
    target = synthetic_he_patch((96, 96), seed=20)
    tiles = np.stack([synthetic_he_patch((48, 48), seed=s) for s in (21, 22, 23)])
    jax_norm = jax_stainnorm.get_normalizer("macenko")
    port_norm = port_stainnorm.get_normalizer("macenko")
    jax_norm.fit(target)
    port_norm.fit(target)
    want = np.asarray(jax_norm.transform_tiles(tiles))
    got = port_norm.transform_tiles(tiles, device="cpu")
    assert got.device.type == "cpu"
    _assert_u8_close(got.numpy(), want)
    constants = port_norm.prepare_tile_transform(tiles[0])
    _assert_u8_close(
        port_norm.transform_tiles(tiles, constants, device="cpu").numpy(),
        np.asarray(jax_norm.transform_tiles(tiles, jax_norm.prepare_tile_transform(tiles[0]))),
    )


@pytest.mark.parametrize(
    ("tiles", "error"),
    [
        (np.zeros((2, 3), np.uint8), TypeError),
        (torch.zeros((2, 3), dtype=torch.float32), ValueError),
        (torch.zeros((2, 4), dtype=torch.uint8), ValueError),
        (torch.zeros((2, 3), dtype=torch.uint8, device="meta"), ValueError),
    ],
)
def test_stain_transform_rejects_bad_input(tiles, error) -> None:
    c = _constants(0)
    with pytest.raises(error):
        port_stain.stain_transform(tiles, c["conc_proj"], c["target_stains"], c["conc_scale"])


def test_cuda_request_without_a_card_raises(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_stainnorm.get_normalizer("ruifrok").transform_tiles(np.zeros((1, 2, 2, 3), np.uint8))
    assert resolve_device("cpu").type == "cpu"


def test_build_reports_missing_nvcc_and_unwritable_dir(monkeypatch, tmp_path) -> None:
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("stain.cu")
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(_build, "BUILD_DIR", blocker / "build")
    with pytest.raises(RuntimeError, match=str(blocker / "build")):
        _build.build("stain.cu")
    name = _build.library_path("stain.cu").name
    assert name.startswith("libstain-") and name.endswith(".so")


def test_library_hash_follows_headers_and_flags(monkeypatch, tmp_path) -> None:
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    before = _build.library_path("k.cu")
    (tmp_path / "k.cuh").write_text("// a header\n")
    with_header = _build.library_path("k.cu")
    (tmp_path / "k.cuh").write_text("// the header, edited\n")
    edited = _build.library_path("k.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    flags = _build.library_path("k.cu")
    assert len({before, with_header, edited, flags}) == 4
    assert all(p.name.startswith("libk-") for p in (before, with_header, edited, flags))


def test_build_keeps_the_ptxas_report(monkeypatch, tmp_path) -> None:
    """A stand-in nvcc writes the library and ptxas-style lines on stderr."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
        "echo \"ptxas info    : Compiling entry function 'kern' for 'sm_90a'\" >&2\n"
        "echo 'ptxas info    : Function properties for kern' >&2\n"
        "echo '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads' >&2\n"
        "echo 'ptxas info    : Used 40 registers, 1024 bytes smem, 440 bytes cmem[0]' >&2\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.build("stain.cu")
    assert lib.read_text() == "lib\n"
    assert lib.parent == tmp_path / "build"
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name, lib.stem + ".ptxas"])
    want = [
        "ptxas info    : Compiling entry function 'kern' for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 1024 bytes smem, 440 bytes cmem[0]",
    ]
    assert _build.ptxas_report("stain.cu") == want
    nvcc.unlink()  # built: a second call neither compiles nor needs nvcc
    assert _build.build("stain.cu") == lib


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiles", *RAGGED_CASES])
def test_cuda_kernel_matches_plain_version_on_the_card(case: str) -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the card")
    c = _constants(7)
    if case == "tiles":
        dev = torch.from_numpy(_tiles(7, (8, 64, 64, 3))).cuda()
    else:
        dev = _ragged(case, "cuda")
        assert (dev.data_ptr() % 16 != 0) == (case == "view_3_bytes_in")
    before = port_stain.stain_transform.launches
    got = port_stain.stain_transform(dev, c["conc_proj"], c["target_stains"], c["conc_scale"])
    torch.cuda.synchronize()
    assert port_stain.stain_transform.launches == before + 1
    want = port_stain.stain_transform_reference(dev, c["conc_proj"], c["target_stains"], c["conc_scale"])
    _assert_u8_close(got.cpu().numpy(), want.cpu().numpy())
