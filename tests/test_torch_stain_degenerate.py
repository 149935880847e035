"""Reinhard on degenerate images, the port against the JAX package.

JAX takes each LAB channel's mean and standard deviation with
``cv2.meanStdDev``; the port sums in the same sequential float64 order
(``tools/stainnorm.py::_mean_std_sequential``). On a flat channel whose value
is not exact in binary, a pairwise sum gives a standard deviation of 0 where
cv2 gives a residual, and the normalised pixels then differ by up to 2
levels. Each of the seven degenerate images of
``tests/test_stain_degenerate.py`` goes through both packages' Reinhard as
the target and as the source: pixels equal, or the same error type.
The statistics of the grey-128 L channel are cv2's to the bit.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.tools import stainnorm as jax_stainnorm
from tiatoolbox_tpu_torch.tools import stainnorm as port_stainnorm


def degenerate_cases() -> dict[str, np.ndarray]:
    """The seven images of ``tests/test_stain_degenerate.py``."""
    rng = np.random.default_rng(0)
    he = synthetic_he_patch((64, 64), seed=2)
    mostly_white = np.full((64, 64, 3), 255, np.uint8)
    mostly_white[28:36, 28:36] = he[28:36, 28:36]
    return {
        "saturated_white": np.full((64, 64, 3), 255, np.uint8),
        "all_black": np.zeros((64, 64, 3), np.uint8),
        "mostly_white_tiny_tissue": mostly_white,
        "single_grey": np.full((64, 64, 3), 128, np.uint8),
        "uniform_noise": rng.integers(0, 255, (64, 64, 3)).astype(np.uint8),
        "two_tone": np.where(np.arange(64)[:, None, None] < 32, np.uint8(230), np.uint8(40))
        * np.ones((64, 64, 3), np.uint8),
        "one_hot_red": np.stack(
            [np.full((64, 64), 255, np.uint8), np.zeros((64, 64), np.uint8), np.zeros((64, 64), np.uint8)],
            axis=-1,
        ),
    }


CASES = sorted(degenerate_cases())


def _run(module, target: np.ndarray, source: np.ndarray):
    """('ok', pixels) or ('error', the exception's type name)."""
    try:
        norm = module.get_normalizer("reinhard")
        norm.fit(target.copy())
        return "ok", norm.transform(source.copy())
    except Exception as exc:  # noqa: BLE001 - the behaviour under comparison
        return "error", type(exc).__name__


def _assert_same(target: np.ndarray, source: np.ndarray) -> None:
    jax_kind, jax_out = _run(jax_stainnorm, target, source)
    port_kind, port_out = _run(port_stainnorm, target, source)
    assert port_kind == jax_kind, (jax_out, port_out)
    if jax_kind == "ok":
        np.testing.assert_array_equal(port_out, jax_out)


@pytest.mark.parametrize("case", CASES)
def test_degenerate_target(case: str) -> None:
    """Fit on the degenerate image, transform H&E: pixels equal (single_grey and one_hot_red were F3)."""
    _assert_same(degenerate_cases()[case], synthetic_he_patch((64, 64), seed=3))


@pytest.mark.parametrize("case", CASES)
def test_degenerate_source(case: str) -> None:
    """Fit on H&E, transform the degenerate image: pixels equal."""
    _assert_same(synthetic_he_patch((64, 64), seed=1), degenerate_cases()[case])


@pytest.mark.parametrize("case", CASES)
def test_degenerate_statistics_as_cv2(case: str) -> None:
    """Means and standard deviations within 1e-13 relative of ``cv2.meanStdDev``; bit for bit on flat channels."""
    img = degenerate_cases()[case]
    for chan in port_stainnorm.ReinhardNormalizer.lab_split(img):
        mean, std = port_stainnorm._mean_std_sequential(chan)
        cv_mean, cv_std = (float(v[0][0]) for v in cv2.meanStdDev(chan))
        if np.all(chan == chan.flat[0]):
            assert (mean, std) == (cv_mean, cv_std)
        else:
            np.testing.assert_allclose([mean, std], [cv_mean, cv_std], rtol=1e-13, atol=0)


def test_grey_128_residual_to_the_bit() -> None:
    """The L channel of grey 128 (53.72549 after ``/ 2.55``): cv2's residual standard deviation."""
    chan = port_stainnorm.ReinhardNormalizer.lab_split(np.full((64, 64, 3), 128, np.uint8))[0]
    mean, std = port_stainnorm._mean_std_sequential(chan)
    assert std == 1.330025261018882e-05
    assert mean == 53.72549057006836
