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

The raw-canvas entry (``hv_energy(canvas[..., 1:3], count=count)``) divides
the pair by ``max(count, 1)`` on load. Its plain version is held against
JAX's ``normalize_canvas`` followed by its ``hv_energy`` within the same
2e-6 (zero counts, a canvas padded wider than the crop, 4 and 5 channels,
ksize 3, 21 and 31), and equals the port's normalise-then-energy bit for
bit. On the card both entries are held to their plain versions at every odd
ksize from 3 to 31, on maps narrower than a 128-column strip, one row and
2049x31.

With ``minmax=`` (the normalised pair's min and max, which the multitask
fetch takes from ``pack_fg_tp``) the energy skips
its min/max pass: it is held against JAX's energy of the normalised view
within the same 2e-6 and, on the CPU and the card, against the entry
without ``minmax`` bit for bit. So is HoVerNet's banded fetch (the packed
plane, then the energy from its min/max): the same planes as before.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiatoolbox_tpu.ops.canvas import normalize_canvas as jax_normalize_canvas
from tiatoolbox_tpu.ops.hv_energy import hv_energy as jax_hv_energy
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
from tiatoolbox_tpu_torch.ops import canvas as canvas_ops
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


def _scale_for(ksize: int) -> float:
    """A scale factor whose ``int(20 * scale) + 1`` is ``ksize``."""
    return (ksize - 0.5) / 20


def _raw_canvas(h: int, w: int, pad_w: int, channels: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """An accumulated ``[h + 3, pad_w, channels]`` canvas and its ``[..., 1]``
    hit count (0 to 3, so some pixels were never hit): channels 1-2 are
    calibrated hv maps times the count, the rest noise."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 4, (h + 3, pad_w, 1)).astype(np.float32)
    canvas = rng.normal(0, 1, (h + 3, pad_w, channels)).astype(np.float32)
    canvas[..., 1:3] = _calibrated_hv(h + 3, pad_w, seed) * np.maximum(count, 1)
    canvas[count[..., 0] == 0] = 0.0
    return canvas, count


RAW_CASES = {
    "4 channels, padded, ksize 21": (60, 70, 76, 4, 21),
    "5 channels, padded, ksize 3": (41, 50, 57, 5, 3),
    "5 channels, padded, ksize 31": (48, 66, 71, 5, 31),
    "4 channels, full width, ksize 31": (35, 40, 40, 4, 31),
    "4 channels, narrow, ksize 21": (30, 9, 12, 4, 21),
}


@pytest.mark.parametrize("name", list(RAW_CASES))
def test_raw_canvas_entry_matches_jax_normalize_then_energy(name: str) -> None:
    h, w, pad_w, channels, ksize = RAW_CASES[name]
    canvas, count = _raw_canvas(h, w, pad_w, channels, seed=len(name))
    normalized = np.asarray(jax_normalize_canvas(canvas, count))
    want = np.asarray(jax_hv_energy(normalized[:h, :w, 1:3], scale_factor=_scale_for(ksize)))
    got = ops.hv_energy(
        torch.from_numpy(canvas)[:h, :w, 1:3], _scale_for(ksize), count=torch.from_numpy(count)[:h, :w]
    ).numpy()
    assert got.shape == want.shape == (h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_raw_canvas_entry_equals_normalize_rows_then_energy(dtype) -> None:
    canvas, count = (torch.from_numpy(a) for a in _raw_canvas(45, 52, 59, 4, seed=4))
    normalized = canvas_ops.normalize_rows(canvas, count, 0, 45, 52)
    want = ops.hv_energy(normalized[..., 1:3], dtype=dtype)
    got = ops.hv_energy(canvas[:45, :52, 1:3], dtype=dtype, count=count[:45, :52])
    assert torch.equal(got, want)
    plain = ops.hv_energy_reference(canvas[:45, :52, 1:3], dtype=dtype, count=count[:45, :52])
    assert torch.equal(plain, want)


@pytest.mark.parametrize("name", list(RAW_CASES))
def test_raw_canvas_entry_with_minmax_matches_jax_and_the_entry_without(name: str) -> None:
    h, w, pad_w, channels, ksize = RAW_CASES[name]
    canvas, count = _raw_canvas(h, w, pad_w, channels, seed=len(name))
    normalized = np.asarray(jax_normalize_canvas(canvas, count))
    want = np.asarray(jax_hv_energy(normalized[:h, :w, 1:3], scale_factor=_scale_for(ksize)))
    tc, tn = torch.from_numpy(canvas), torch.from_numpy(count)
    _, minmax = canvas_ops.pack_fg_tp(tc, tn, h, w)
    got = ops.hv_energy(tc[:h, :w, 1:3], _scale_for(ksize), count=tn[:h, :w], minmax=minmax)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert torch.equal(got, ops.hv_energy(tc[:h, :w, 1:3], _scale_for(ksize), count=tn[:h, :w]))


@pytest.mark.parametrize("head_channels", [[1, 2, 1], [1, 2]])
def test_banded_fetch_hooks_give_the_planes_of_jax_and_of_the_entries_before(head_channels) -> None:
    """HoVerNet's banded fetch on the CPU: the packed plane and the energy
    from the plane's hv min/max equal ``pack_fg_tp`` and the raw-canvas
    energy without ``minmax`` bit for bit, and JAX's hooks on its normalised
    canvas (the plane exactly, the energy within 2e-6)."""
    from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet

    h, w = 45, 52
    canvas, count = _raw_canvas(h, w, 59, 1 + sum(head_channels), seed=11)
    canvas[..., 0] = np.abs(canvas[..., 0])
    if len(head_channels) == 3:
        canvas[..., 3] = np.random.default_rng(12).integers(0, 6, (h + 3, 59)) * np.maximum(count[..., 0], 1)
    canvas = canvas[..., : sum(head_channels)].copy()
    tc, tn = torch.from_numpy(canvas), torch.from_numpy(count)
    plane, minmax = HoVerNet.block_fetch_transform(None, tc, tn, h, w, head_channels)
    energy = HoVerNet.final_fetch_transform(None, tc, tn, h, w, head_channels, minmax)
    tp_channel = 3 if len(head_channels) == 3 else -1
    assert torch.equal(plane, canvas_ops.pack_fg_tp(tc, tn, h, w, tp_channel)[0])
    assert torch.equal(energy, ops.hv_energy(tc[:h, :w, 1:3], count=tn[:h, :w])[..., None])
    normalized = jax_normalize_canvas(canvas, count)[:h, :w]
    np.testing.assert_array_equal(plane.numpy(), np.asarray(JaxHoVerNet.block_fetch_transform(None, normalized, head_channels)))
    want = np.asarray(JaxHoVerNet.final_fetch_transform(None, normalized, head_channels))
    np.testing.assert_allclose(energy.numpy(), want, rtol=0, atol=TOL)


def test_minmax_of_another_shape_is_refused() -> None:
    canvas, count = (torch.from_numpy(a) for a in _raw_canvas(20, 20, 24, 4, seed=5))
    with pytest.raises(ValueError, match="minmax must be float32"):
        ops.hv_energy(canvas[:20, :20, 1:3], count=count[:20, :20], minmax=torch.zeros(2))
    with pytest.raises(ValueError, match="minmax must be float32"):
        ops.hv_energy(canvas[:20, :20, 1:3], minmax=torch.zeros(4, dtype=torch.float64))


def test_raw_canvas_entry_rejects_a_count_of_another_shape() -> None:
    canvas, count = (torch.from_numpy(a) for a in _raw_canvas(20, 20, 24, 4, seed=5))
    with pytest.raises(ValueError, match="count must be float32"):
        ops.hv_energy(canvas[:20, :20, 1:3], count=count)
    with pytest.raises(ValueError, match="count must be float32"):
        ops.hv_energy(canvas[:20, :20, 1:3], count=count[:20, :20].double())


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


@pytest.mark.cuda
@pytest.mark.parametrize("ksize", list(range(3, 32, 2)))
def test_energy_kernel_at_every_ksize_on_the_card(ksize: int) -> None:
    """Each odd ksize has its own instance of the Sobel pass; a 150x300 map
    has border and interior strips and several runs of rows."""
    _on_card()
    hv = torch.from_numpy(_calibrated_hv(150, 300, seed=ksize)).cuda()
    got = ops.hv_energy(hv, _scale_for(ksize))
    want = ops.hv_energy_reference(hv, _scale_for(ksize))
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


RAGGED_MAPS = {
    "2049x31": (_random_hv, 2049, 31),
    "narrower than a strip 70x100": (_calibrated_hv, 70, 100),
    "one column 40x1": (_random_hv, 40, 1),
    "one row 1x300": (_one_row_hv, 1, 300),
    "strip and one column 64x129": (_random_hv, 64, 129),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RAGGED_MAPS))
def test_energy_kernel_on_ragged_maps_on_the_card(name: str) -> None:
    _on_card()
    make, h, w = RAGGED_MAPS[name]
    hv = make(h, w, seed=len(name))
    if w == 1:  # one column: dx is zero exactly only where h is constant
        hv[..., 0] = -0.5
    hv = torch.from_numpy(hv).cuda()
    got = ops.hv_energy(hv)
    want = ops.hv_energy_reference(hv)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RAW_CASES))
def test_raw_canvas_entry_matches_plain_version_on_the_card(name: str) -> None:
    """The raw-canvas entry against plain K3 followed by plain K5, float32 and float16."""
    _on_card()
    h, w, pad_w, channels, ksize = RAW_CASES[name]
    canvas, count = (torch.from_numpy(a).cuda() for a in _raw_canvas(h, w, pad_w, channels, seed=len(name)))
    normalized = canvas_ops.normalize_rows_reference(canvas, count, 0, h, w)
    want = ops.hv_energy_reference(normalized[..., 1:3], _scale_for(ksize))
    before = ops.hv_energy.launches
    got = ops.hv_energy(canvas[:h, :w, 1:3], _scale_for(ksize), count=count[:h, :w])
    half = ops.hv_energy(canvas[:h, :w, 1:3], _scale_for(ksize), torch.float16, count=count[:h, :w])
    torch.cuda.synchronize()
    assert ops.hv_energy.launches == before + 2
    assert float((got - want).abs().max()) <= TOL
    assert float((half.float() - want).abs().max()) <= TOL + 2**-12


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RAW_CASES))
def test_energy_with_minmax_equals_energy_without_on_the_card(name: str) -> None:
    """K5 from K6's min/max (one launch each) against K5's own three passes,
    bit for bit, float32 and float16, on the raw canvas and its normalised view."""
    _on_card()
    h, w, pad_w, channels, ksize = RAW_CASES[name]
    canvas, count = (torch.from_numpy(a).cuda() for a in _raw_canvas(h, w, pad_w, channels, seed=len(name)))
    scale = _scale_for(ksize)
    _, minmax = canvas_ops.pack_fg_tp(canvas, count, h, w)
    view = canvas_ops.normalize_rows(canvas, count, 0, h, w)[..., 1:3]
    for dtype in (torch.float32, torch.float16):
        before = ops.hv_energy.launches
        got = ops.hv_energy(canvas[:h, :w, 1:3], scale, dtype, count=count[:h, :w], minmax=minmax)
        got_view = ops.hv_energy(view, scale, dtype, minmax=minmax)
        want = ops.hv_energy(canvas[:h, :w, 1:3], scale, dtype, count=count[:h, :w])
        torch.cuda.synchronize()
        assert ops.hv_energy.launches == before + 3
        assert torch.equal(got, want) and torch.equal(got_view, want), dtype
