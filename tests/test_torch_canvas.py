"""Canvas stitching and band extraction: the port against the JAX package on the CPU.

``scatter_accumulate`` and ``extract_patches`` are held to exact equality:
both sides add float32 patches in the same order one element at a time, or
copy bytes. Normalisation is one IEEE division and a round-to-nearest cast,
also exact. ``BandPlan.build`` must equal the JAX plan field by field. The
card tests (marker ``cuda``) hold each CUDA kernel against its plain
version bit for bit; they skip where there is no card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiatoolbox_tpu.ops import canvas as jax_canvas
from tiatoolbox_tpu.ops import region as jax_region
from tiatoolbox_tpu_torch.ops import canvas, region

H, W, C = 40, 52, 3


def _case(name: str):
    """(patches [N, h, w, C], positions [N, 2] (y, x), valid [N]) of a named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "overlapping":
        pos = np.array([[0, 0], [4, 6], [8, 12], [2, 9], [4, 6], [20, 30]])
        valid = np.ones(len(pos), bool)
    elif name == "invalid_entries":
        pos = np.array([[0, 0], [4, 6], [8, 12], [2, 9], [0, 0]])
        valid = np.array([True, False, True, False, False])
    elif name == "at_the_edge":
        pos = np.array([[H - 16, W - 16], [H - 16, 0], [0, W - 16], [H - 20, W - 18]])
        valid = np.ones(len(pos), bool)
    elif name == "one_patch":
        pos = np.array([[7, 3]])
        valid = np.ones(1, bool)
    elif name == "clamped":  # past the edge, or negative (counted from the end), then clamped
        pos = np.array([[-5, 3], [H, W], [10, W - 4], [3, -1]])
        valid = np.ones(len(pos), bool)
    else:
        raise ValueError(name)
    patches = rng.random((len(pos), 16, 16, C), dtype=np.float32)
    return patches, pos.astype(np.int32), valid


CASES = ["overlapping", "invalid_entries", "at_the_edge", "one_patch", "clamped"]


def _start_canvas(seed: int = 1):
    rng = np.random.default_rng(seed)
    return rng.random((H, W, C), dtype=np.float32), rng.integers(0, 3, (H, W, 1)).astype(np.float32)


@pytest.mark.parametrize("name", CASES)
def test_scatter_accumulate_equals_jax_exactly(name: str) -> None:
    patches, pos, valid = _case(name)
    c0, n0 = _start_canvas()
    want_c, want_n = jax_canvas.scatter_accumulate(
        jnp.asarray(c0), jnp.asarray(n0), jnp.asarray(patches), jnp.asarray(pos), jnp.asarray(valid)
    )
    c, n = torch.from_numpy(c0.copy()), torch.from_numpy(n0.copy())
    got_c, got_n = canvas.scatter_accumulate(c, n, torch.from_numpy(patches), pos, valid)
    assert got_c is c and got_n is n  # in place
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_normalize_rows_and_argmax_equal_jax(dtype) -> None:
    c0, n0 = _start_canvas(2)
    full = np.asarray(jax_canvas.normalize_canvas(jnp.asarray(c0), jnp.asarray(n0)))
    np.testing.assert_array_equal(
        canvas.normalize_canvas(torch.from_numpy(c0), torch.from_numpy(n0)).numpy(), full
    )
    jdtype = jnp.float16 if dtype == torch.float16 else jnp.float32
    for y0, bh, w in ((0, H, W), (5, 17, 31), (H - 1, 1, 1), (3, 0, 7)):
        got = canvas.normalize_rows(torch.from_numpy(c0), torch.from_numpy(n0), y0, bh, w, dtype)
        assert got.dtype == dtype and tuple(got.shape) == (bh, w, C)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(full[y0 : y0 + bh, :w]).astype(jdtype)))
    np.testing.assert_array_equal(
        canvas.canvas_argmax(torch.from_numpy(full.copy())).numpy(),
        np.asarray(jax_canvas.canvas_argmax(jnp.asarray(full))),
    )
    with pytest.raises(ValueError, match="outside"):
        canvas.normalize_rows(torch.from_numpy(c0), torch.from_numpy(n0), 30, 11, W)
    with pytest.raises(ValueError, match="float32 or float16"):
        canvas.normalize_rows(torch.from_numpy(c0), torch.from_numpy(n0), 0, H, W, torch.bfloat16)


def test_device_canvas_marks_out_of_range_patches_invalid_like_jax() -> None:
    rng = np.random.default_rng(3)
    patches = rng.random((5, 16, 16, 2), dtype=np.float32)
    pos = np.array([[0, 0], [-1, 4], [H - 15, 2], [10, W - 16], [10, W - 15]])
    jax_dc = jax_canvas.DeviceCanvas((H, W), 2)
    port_dc = canvas.DeviceCanvas((H, W), 2, device="cpu")
    for valid in (None, np.array([True, True, True, False, True])):
        jax_dc.add(patches, pos, valid)
        port_dc.add(torch.from_numpy(patches), pos, valid)
    np.testing.assert_array_equal(port_dc.canvas.numpy(), np.asarray(jax_dc.canvas))
    np.testing.assert_array_equal(port_dc.count.numpy(), np.asarray(jax_dc.count))
    # only the two patches inside the canvas landed, once per add (and one of them twice)
    assert port_dc.count.sum() == 16 * 16 * 3
    np.testing.assert_array_equal(port_dc.normalized().numpy(), np.asarray(jax_dc.normalized()))
    np.testing.assert_array_equal(
        port_dc.normalized(torch.float16).numpy(), np.asarray(jax_dc.normalized(jnp.float16))
    )
    np.testing.assert_array_equal(port_dc.predictions().numpy(), np.asarray(jax_dc.predictions()))


def test_scatter_accumulate_rejects_bad_arguments() -> None:
    c, n = torch.zeros((8, 8, 2)), torch.zeros((8, 8, 1))
    with pytest.raises(ValueError, match="do not fit"):
        canvas.scatter_accumulate(c, n, torch.zeros((1, 9, 4, 2)), [[0, 0]], [True])
    with pytest.raises(ValueError, match="validity flags"):
        canvas.scatter_accumulate(c, n, torch.zeros((2, 4, 4, 2)), [[0, 0], [1, 1]], [True])
    with pytest.raises(ValueError, match="float32"):
        canvas.scatter_accumulate(c, n, torch.zeros((1, 4, 4, 2), dtype=torch.float64), [[0, 0]], [True])
    with pytest.raises(ValueError, match="count"):
        canvas.scatter_accumulate(c, torch.zeros((8, 8, 2)), torch.zeros((1, 4, 4, 2)), [[0, 0]], [True])


def _band(seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (37, 45, 3), dtype=np.uint8)


@pytest.mark.parametrize(
    "starts",
    [[[0, 0], [5, 7], [21, 29], [3, 0]], [[0, 0]], [[-3, 2], [30, 40], [21, 30]]],
    ids=["inside", "one", "clamped"],
)
def test_extract_patches_equals_jax_exactly(starts) -> None:
    band = _band()
    starts = np.asarray(starts, np.int32)
    want = np.asarray(jax_region.extract_patches(jnp.asarray(band), starts, (16, 16)))
    got = region.extract_patches(torch.from_numpy(band), starts, (16, 16))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def _mesh(xs, ys, patch=(64, 64)) -> np.ndarray:
    gx, gy = np.meshgrid(xs, ys)
    tl = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    return np.concatenate([tl, tl + np.array(patch)], axis=-1)


REGULAR = _mesh(np.arange(0, 10 * 48, 48), np.arange(-16, 7 * 48 - 16, 48))
PLAN_CASES = {
    "regular": (REGULAR, {}),
    "regular_one_band": (REGULAR, {"min_bands": 1}),
    "regular_no_band_target": (REGULAR, {"min_bands": 0}),
    "min_bands_split_3": (REGULAR, {"min_bands": 3}),
    "byte_budget": (REGULAR, {"max_band_bytes": 150_000}),
    "one_row": (_mesh(np.arange(0, 5 * 48, 48), [0]), {}),
    "x_overlap_only": (_mesh(np.arange(0, 6 * 48, 48), np.arange(0, 4 * 64, 64)), {}),
    "y_gap_halo_heavy": (
        _mesh(np.arange(0, 3 * 60, 60), np.arange(0, 12 * 80, 80)),
        {"min_bands": 6},
    ),
    "irregular_mesh": (REGULAR[np.arange(len(REGULAR)) != 13], {}),
    "stride_not_uniform": (_mesh([0, 48, 100], [0, 48]), {}),
    "stride_at_least_patch": (_mesh(np.arange(0, 4 * 64, 64), np.arange(0, 3 * 64, 64)), {}),
    "sizes_differ": (np.concatenate([REGULAR[:, :2], REGULAR[:, 2:] + 1], axis=-1), {}),
    "empty": (np.zeros((0, 4), np.int64), {}),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_band_plan_equals_jax_field_by_field(name: str) -> None:
    inputs, kwargs = PLAN_CASES[name]
    stride = (60, 80) if name == "y_gap_halo_heavy" else (48, 48)
    if name == "stride_at_least_patch":
        stride = (64, 64)
    args = (inputs, (64, 64), stride)
    want = jax_region.BandPlan.build(*args, **kwargs)
    got = region.BandPlan.build(*args, **kwargs)
    if want is None:
        assert got is None
        return
    assert (got.patch_h, got.patch_w, got.wire_pixels) == (want.patch_h, want.patch_w, want.wire_pixels)
    assert len(got.bands) == len(want.bands) > 0
    for g, w in zip(got.bands, want.bands):
        assert (g.read_x, g.read_y, g.band_w, g.band_h) == (w.read_x, w.read_y, w.band_w, w.band_h)
        for field in ("ds_indices", "starts_local"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_band_plan_cases_cover_accepted_and_rejected_grids() -> None:
    def bands(name: str):
        plan = region.BandPlan.build(PLAN_CASES[name][0], (64, 64), (48, 48), **PLAN_CASES[name][1])
        return None if plan is None else len(plan.bands)

    assert (bands("regular"), bands("regular_one_band"), bands("min_bands_split_3")) == (4, 1, 3)
    assert bands("byte_budget") > 4
    assert bands("irregular_mesh") is bands("stride_not_uniform") is bands("sizes_differ") is None


def _on_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_scatter_kernel_matches_plain_version_on_the_card(name: str) -> None:
    _on_card()
    patches, pos, valid = _case(name)
    c0, n0 = _start_canvas()
    want_c, want_n = canvas.scatter_accumulate_reference(
        torch.from_numpy(c0).cuda(), torch.from_numpy(n0).cuda(), torch.from_numpy(patches).cuda(), pos, valid
    )
    before = canvas.scatter_accumulate.launches
    got_c, got_n = canvas.scatter_accumulate(
        torch.from_numpy(c0).cuda(), torch.from_numpy(n0).cuda(), torch.from_numpy(patches).cuda(), pos, valid
    )
    torch.cuda.synchronize()
    assert canvas.scatter_accumulate.launches == before + 1
    assert torch.equal(got_c, want_c) and torch.equal(got_n, want_n)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 8, 11])
def test_scatter_kernel_matches_plain_version_at_any_channel_count(channels: int) -> None:
    """A thread carries up to 8 channels; more take a second group of threads."""
    _on_card()
    rng = np.random.default_rng(channels)
    patches = torch.from_numpy(rng.random((6, 16, 16, channels), dtype=np.float32)).cuda()
    pos = np.array([[0, 0], [4, 6], [8, 12], [H - 16, W - 16], [4, 6], [2, 9]], np.int32)
    valid = np.array([True, True, False, True, True, True])
    c0 = torch.from_numpy(rng.random((H, W, channels), dtype=np.float32)).cuda()
    n0 = torch.zeros((H, W, 1), device="cuda")
    got = canvas.scatter_accumulate(c0.clone(), n0.clone(), patches, pos, valid)
    want = canvas.scatter_accumulate_reference(c0.clone(), n0.clone(), patches, pos, valid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_normalize_kernel_matches_plain_version_on_the_card(dtype) -> None:
    _on_card()
    c0, n0 = (torch.from_numpy(a).cuda() for a in _start_canvas(2))
    for y0, bh, w in ((0, H, W), (5, 17, 31), (H - 1, 1, 1)):
        got = canvas.normalize_rows(c0, n0, y0, bh, w, dtype)
        want = canvas.normalize_rows_reference(c0, n0, y0, bh, w, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pw", [16, 15])
def test_extract_kernel_matches_plain_version_on_the_card(pw: int) -> None:
    _on_card()
    band = torch.from_numpy(_band()).cuda()
    starts = np.array([[0, 0], [5, 7], [21, 29], [3, 0], [-3, 40]], np.int32)
    got = region.extract_patches(band, starts, (16, pw))
    want = region.extract_patches_reference(band, starts, (16, pw))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
