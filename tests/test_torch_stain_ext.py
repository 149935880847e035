"""Phase A's stain API completed: Reinhard and Vahadane, the port against the JAX package.

- ``rgb2lab_u8`` and ``lab2rgb_u8`` (the port's numpy copies of OpenCV's 8-bit
  ``COLOR_RGB2LAB`` and ``COLOR_LAB2RGB``) bit for bit with cv2 over all
  2^24 RGB colours and all 2^24 Lab triples;
- Reinhard ``fit``/``transform``/``transform_tiles`` bit for bit with JAX's
  (cv2's LAB and ``meanStdDev`` there), its means and standard deviations
  within 1e-10 relative (``meanStdDev`` sums in its own order: the standard
  deviations of the L channel part by about 1e-12 relative);
- Vahadane's stain matrix within 1e-6 of JAX's (scikit-learn's dictionary
  learning there, the port's numpy copy here) on seeded H&E images, its
  normalised images and tiles within 1 uint8 level;
- ``get_normalizer`` with each name, raising ``MethodNotSupportedError`` and
  ``ValueError`` where JAX does; the port's ``MethodNotSupportedError`` is
  its own class, not a ``ValueError``.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.tools import stainextract as jax_stainextract
from tiatoolbox_tpu.tools import stainnorm as jax_stainnorm
from tiatoolbox_tpu.utils import exceptions as jax_exceptions
from tiatoolbox_tpu_torch.tools import stainextract as port_stainextract
from tiatoolbox_tpu_torch.tools import stainnorm as port_stainnorm
from tiatoolbox_tpu_torch.utils import exceptions as port_exceptions
from tiatoolbox_tpu_torch.utils.misc import lab2rgb_u8, lab_luminosity_u8, rgb2lab_u8

MATRIX_TOL = 1e-6


def _every_triple() -> np.ndarray:
    c = np.arange(1 << 24, dtype=np.int64)
    return np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)


def test_rgb2lab_every_colour_bit_exact() -> None:
    rgb = _every_triple()
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    got = rgb2lab_u8(rgb)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lab_luminosity_u8(rgb), want[..., 0])


def test_lab2rgb_every_triple_bit_exact() -> None:
    lab = _every_triple()
    np.testing.assert_array_equal(lab2rgb_u8(lab), cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))


def test_lab_shapes() -> None:
    img = synthetic_he_patch((7, 5), seed=1)
    assert rgb2lab_u8(img).shape == (5, 7, 3)
    assert lab2rgb_u8(rgb2lab_u8(img)[None]).shape == (1, 5, 7, 3)


def _pair(name: str, target: np.ndarray):
    jax_norm = jax_stainnorm.get_normalizer(name)
    port_norm = port_stainnorm.get_normalizer(name)
    jax_norm.fit(target)
    port_norm.fit(target)
    return jax_norm, port_norm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reinhard_against_jax(seed) -> None:
    target = synthetic_he_patch((192, 160), seed=seed)
    source = synthetic_he_patch((150, 130), seed=seed + 10)
    jax_norm, port_norm = _pair("reinhard", target)
    for jax_value, port_value in zip(jax_norm.target_means + jax_norm.target_stds,
                                     port_norm.target_means + port_norm.target_stds):
        assert port_value == pytest.approx(jax_value, rel=1e-10, abs=1e-12)
    np.testing.assert_array_equal(port_norm.transform(source), jax_norm.transform(source))
    tiles = np.stack([source[:64, :64], source[64:128, 32:96]])
    np.testing.assert_array_equal(port_norm.transform_tiles(tiles), np.asarray(jax_norm.transform_tiles(tiles)))
    chans_jax = jax_norm.lab_split(source)
    chans_port = port_norm.lab_split(source)
    for a, b in zip(chans_jax, chans_port):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        port_norm.merge_back(*(c.copy() for c in chans_port)), jax_norm.merge_back(*(c.copy() for c in chans_jax))
    )


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_vahadane_against_jax(seed) -> None:
    target = synthetic_he_patch((160, 128), seed=seed)
    source = synthetic_he_patch((128, 112), seed=seed + 20)
    jax_norm, port_norm = _pair("vahadane", target)
    np.testing.assert_allclose(port_norm.stain_matrix_target, jax_norm.stain_matrix_target, rtol=0, atol=MATRIX_TOL)
    for img in (target, source):
        np.testing.assert_allclose(
            port_stainextract.VahadaneExtractor().get_stain_matrix(img),
            jax_stainextract.VahadaneExtractor().get_stain_matrix(img),
            rtol=0, atol=MATRIX_TOL,
        )
    diff = np.abs(port_norm.transform(source).astype(int) - jax_norm.transform(source))
    assert diff.max() <= 1
    tiles = np.stack([source[:64, :64], source[32:96, 48:112]])
    jax_c = jax_norm.prepare_tile_transform(source)
    port_c = port_norm.prepare_tile_transform(source)
    for key in jax_c:
        np.testing.assert_allclose(port_c[key], jax_c[key], rtol=1e-5, atol=1e-6)
    got = port_norm.transform_tiles(tiles, port_c, device="cpu")
    assert isinstance(got, torch.Tensor)
    diff = np.abs(got.numpy().astype(int) - np.asarray(jax_norm.transform_tiles(tiles, jax_c)))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_dl_output_for_h_and_e() -> None:
    rng = np.random.default_rng(0)
    for _ in range(10):
        d = rng.random((2, 3))
        np.testing.assert_array_equal(
            port_stainextract.dl_output_for_h_and_e(d.copy()), jax_stainextract.dl_output_for_h_and_e(d.copy())
        )


@pytest.mark.parametrize("name", ["reinhard", "ruifrok", "macenko", "vahadane", "custom", "MACENKO"])
def test_get_normalizer_names(name) -> None:
    kwargs = {"stain_matrix": np.array([[0.6, 0.7, 0.3], [0.1, 0.9, 0.1]])} if name == "custom" else {}
    port_norm = port_stainnorm.get_normalizer(name, **kwargs)
    jax_norm = jax_stainnorm.get_normalizer(name, **kwargs)
    assert type(port_norm).__name__ == type(jax_norm).__name__


def test_get_normalizer_errors_as_jax() -> None:
    with pytest.raises(jax_exceptions.MethodNotSupportedError):
        jax_stainnorm.get_normalizer("unknown")
    with pytest.raises(port_exceptions.MethodNotSupportedError):
        port_stainnorm.get_normalizer("unknown")
    # the repair: the port's class is no ValueError, as JAX's is none
    try:
        port_stainnorm.get_normalizer("unknown")
    except ValueError:
        pytest.fail("an unknown name raised ValueError")
    except port_exceptions.MethodNotSupportedError as exc:
        assert exc.message == "Method is not supported"
    assert not issubclass(port_exceptions.MethodNotSupportedError, ValueError)
    matrix = np.eye(3)[:2]
    for pkg in (jax_stainnorm, port_stainnorm):
        with pytest.raises(ValueError, match="only defined"):
            pkg.get_normalizer("macenko", stain_matrix=matrix)
        with pytest.raises(ValueError, match="is None"):
            pkg.get_normalizer("custom")


def test_exceptions_copy() -> None:
    for name in ("FileNotSupportedError", "MethodNotSupportedError"):
        port_exc = getattr(port_exceptions, name)()
        jax_exc = getattr(jax_exceptions, name)()
        assert port_exc.message == jax_exc.message and str(port_exc) == str(jax_exc)
    e = port_exceptions.DimensionMismatchError((1, 2), (3,))
    assert str(e) == str(jax_exceptions.DimensionMismatchError((1, 2), (3,)))
    from tiatoolbox_tpu_torch.tools import patchextraction
    from tiatoolbox_tpu_torch.wsicore import wsireader

    assert wsireader.FileNotSupportedError is port_exceptions.FileNotSupportedError
    with pytest.raises(port_exceptions.MethodNotSupportedError):
        patchextraction.get_patch_extractor("fixedwindow", input_img=np.zeros((8, 8, 3), np.uint8))
