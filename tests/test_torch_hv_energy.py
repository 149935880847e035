"""The watershed energy (K5): the port's plain version against the JAX program on the CPU.

``tiatoolbox_tpu_torch.ops.hv_energy`` takes the same seeded numpy hv maps
as ``tiatoolbox_tpu.ops.hv_energy``. Tolerance: 2e-6 absolute on the
energy in [0, 1]. Both sum the 21 Sobel taps in float32 in their own order
(XLA's convolution and PyTorch's), and the integer taps reach 184756, so
the gradients differ by a few ulp of their size before the min-max
normalisation; measured, the two differ by at most a few 1e-7 on these maps.

The Sobel taps are checked equal to ``cv2.getDerivKernels``, and the card
tests (marker ``cuda``, skipped without a card) hold the CUDA kernel to its
plain version within the same 2e-6 on ragged shapes: odd sizes, widths
under the 21-tap kernel, a one-row map, a strided view of a 4-channel
canvas and the float16 output. (On one row the dy gradient is zero in exact
arithmetic and float32 rounding noise after any implementation's sums; the
one-row case keeps v constant so the energy is defined, ``_one_row_hv``.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu.ops.hv_energy import hv_energy as jax_hv_energy
from tiatoolbox_tpu_torch.ops import hv_energy as ops

TOL = 2e-6


def _calibrated_hv(h: int, w: int, seed: int) -> np.ndarray:
    """Nucleus-like hv maps: ramps of -1..1 across a few discs, plus noise."""
    rng = np.random.default_rng(seed)
    hv = np.zeros((h, w, 2), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(max(1, h * w // 400)):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(4, 10)
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        hv[inside, 0] = np.clip((xx[inside] - cx) / r, -1, 1)
        hv[inside, 1] = np.clip((yy[inside] - cy) / r, -1, 1)
    return hv + rng.normal(0, 0.01, hv.shape).astype(np.float32)


def _random_hv(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 3, (h, w, 2)).astype(np.float32)


def _one_row_hv(h: int, w: int, seed: int) -> np.ndarray:
    """A one-row map. Its dy Sobel is zero in exact arithmetic; in float32 it
    is rounding noise, which the min-max normalisation would blow up to
    [0, 1] differently in every implementation. With a constant v channel
    v' is exactly 0, Sv exactly 0, and the energy is defined (all ones)."""
    hv = _random_hv(h, w, seed)
    hv[..., 1] = 0.25
    return hv


CASES = {
    "calibrated 96x128": (_calibrated_hv, 96, 128, 1.0),
    "calibrated 37x53": (_calibrated_hv, 37, 53, 1.0),
    "random 64x64": (_random_hv, 64, 64, 1.0),
    "random 33x17 (width under 21)": (_random_hv, 33, 17, 1.0),
    "random 5x9": (_random_hv, 5, 9, 1.0),
    "one row": (_one_row_hv, 1, 40, 1.0),
    "calibrated 50x70 scale 0.5": (_calibrated_hv, 50, 70, 0.5),
    "calibrated 50x70 scale 1.5": (_calibrated_hv, 50, 70, 1.5),
}


@pytest.mark.parametrize("ksize", [3, 5, 11, 21, 31])
def test_sobel_taps_equal_cv2(ksize: int) -> None:
    import cv2  # imported here only: this file's card tests run where cv2 may be missing

    deriv, smooth = ops.sobel_kernels(ksize)
    kd, ks = cv2.getDerivKernels(1, 0, ksize=ksize, normalize=False)
    np.testing.assert_array_equal(deriv, kd.ravel().astype(np.float32))
    np.testing.assert_array_equal(smooth, ks.ravel().astype(np.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_energy_matches_jax(name: str) -> None:
    make, h, w, scale = CASES[name]
    hv = make(h, w, seed=len(name))
    want = np.asarray(jax_hv_energy(hv, scale_factor=scale))
    got = ops.hv_energy(torch.from_numpy(hv), scale_factor=scale).numpy()
    assert got.shape == want.shape == (h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_strided_view_and_float16_output_on_the_cpu() -> None:
    canvas = np.random.default_rng(3).normal(0, 1, (40, 30, 4)).astype(np.float32)
    view = torch.from_numpy(canvas)[..., 1:3]
    want = ops.hv_energy(torch.from_numpy(np.ascontiguousarray(canvas[..., 1:3])))
    assert torch.equal(ops.hv_energy(view), want)
    assert torch.equal(ops.hv_energy(view, dtype=torch.float16), want.to(torch.float16))


def test_reflect_index_is_numpy_reflect() -> None:
    for n in (1, 2, 3, 7, 21):
        for r in (1, 10, 25):
            want = np.pad(np.arange(n), r, mode="reflect")
            np.testing.assert_array_equal(np.arange(n)[ops.reflect101_index(n, r)], want)


def test_hv_energy_rejects_bad_arguments() -> None:
    with pytest.raises(ValueError, match=r"\[H, W, 2\]"):
        ops.hv_energy(torch.zeros(4, 4, 3))
    with pytest.raises(ValueError, match="float32"):
        ops.hv_energy(torch.zeros(4, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="ksize"):
        ops.hv_energy(torch.zeros(4, 4, 2), scale_factor=2.0)
    with pytest.raises(ValueError, match="odd"):
        ops.sobel_kernels(20)


def _on_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_energy_kernel_matches_plain_version_on_the_card(name: str) -> None:
    _on_card()
    make, h, w, scale = CASES[name]
    hv = torch.from_numpy(make(h, w, seed=len(name))).cuda()
    got = ops.hv_energy(hv, scale_factor=scale)
    want = ops.hv_energy_reference(hv, scale_factor=scale)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_energy_kernel_on_a_canvas_view_and_float16_on_the_card() -> None:
    _on_card()
    canvas = torch.from_numpy(_calibrated_hv(301, 257, seed=9)).cuda()
    canvas = torch.cat([canvas[..., :1], canvas, canvas[..., 1:]], dim=-1).contiguous()
    view = canvas[..., 1:3]
    want = ops.hv_energy_reference(view)
    got = ops.hv_energy(view)
    half = ops.hv_energy(view, dtype=torch.float16)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL
    assert float((half.float() - want).abs().max()) <= TOL + 2**-11
