"""Canvas stitching and band extraction: the port against the JAX package on the CPU.

``scatter_accumulate`` and ``extract_patches`` are held to exact equality:
both sides add float32 patches in the same order one element at a time, or
copy bytes. Normalisation is one IEEE division and a round-to-nearest cast,
also exact, and so is the packed plane of the multitask engine
(``pack_fg_tp``: the same division, ``>= 0.5``, half-to-even rounding and
shift as JAX's normalised block with HoVerNet's ``block_fetch_transform``),
and so is the min/max of the normalised hv pair that ``pack_fg_tp`` also
gives (the same division, then ``amin``/``amax`` against
``jnp.min``/``jnp.max``, which any order gives exactly). A rounded type
outside ``[0, 255]`` saturates, as JAX's ``astype(jnp.uint8)`` does.
``BandPlan.build`` must equal the JAX plan field by field. The card tests
(marker ``cuda``) hold each CUDA kernel against its plain version bit for
bit; they skip where there is no card.
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


@pytest.mark.parametrize("n_valid", [7, 6, 8, 17, 0])
def test_scatter_launches_split_the_valid_entries_in_order(n_valid: int) -> None:
    """Chunks of 7 (the kernel takes SCATTER_ENTRIES): a chunk, one less,
    one more, about 2.5 chunks, none. Stitching chunk by chunk with the plain
    version, in order, equals JAX's scan over the whole batch."""
    rng = np.random.default_rng(n_valid)
    n = n_valid + 5
    pos = rng.integers(-4, max(H, W), (n, 2)).astype(np.int32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    patches = rng.random((n, 9, 11, C), dtype=np.float32)
    table = canvas.patch_table(pos, valid, (H, W), (9, 11))
    launches = canvas.scatter_launches(table, (9, 11), chunk=7)
    assert [len(e) for e, _ in launches] == [min(7, n_valid - i) for i in range(0, n_valid, 7)]
    got_index = np.concatenate([e[:, 2] for e, _ in launches]) if launches else np.zeros(0, int)
    np.testing.assert_array_equal(got_index, np.flatnonzero(valid))
    c0, n0 = _start_canvas(n_valid)
    c, cn = torch.from_numpy(c0.copy()), torch.from_numpy(n0.copy())
    for entries, (y0, x0, bh, bw) in launches:
        assert entries.dtype == np.int32 and entries.flags.c_contiguous
        np.testing.assert_array_equal(entries[:, :2], table[entries[:, 2], :2])
        assert (y0, x0) == tuple(entries[:, :2].min(axis=0))
        assert (y0 + bh, x0 + bw) == tuple(entries[:, :2].max(axis=0) + (9, 11))
        assert 0 <= y0 and y0 + bh <= H and 0 <= x0 and x0 + bw <= W
        one = np.zeros(n, bool)
        one[entries[:, 2]] = True
        canvas.scatter_accumulate_reference(c, cn, torch.from_numpy(patches), pos, one)
    want_c, want_n = jax_canvas.scatter_accumulate(
        jnp.asarray(c0), jnp.asarray(n0), jnp.asarray(patches), jnp.asarray(pos), jnp.asarray(valid)
    )
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(cn.numpy(), np.asarray(want_n))


def test_launch_sizes_match_the_kernel_sources() -> None:
    """The wrappers' chunk sizes are the kernels' parameter-table sizes,
    which fit CUDA's portable 4,096 bytes of kernel parameters."""
    from tiatoolbox_tpu_torch._build import CSRC_DIR

    def constant(source: str, name: str) -> int:
        text = (CSRC_DIR / source).read_text()
        return int(text.split(f"constexpr int {name} = ")[1].split(";")[0])

    assert constant("canvas.cu", "kScatterEntries") == canvas.SCATTER_ENTRIES
    assert constant("region.cu", "kExtractPatches") == region.EXTRACT_PATCHES
    assert 60 + 12 * canvas.SCATTER_ENTRIES <= 4096 and 48 + 8 * region.EXTRACT_PATCHES <= 4096


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


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_band_offsets_are_the_first_byte_of_each_patch(channels: int) -> None:
    band = np.random.default_rng(channels).integers(0, 256, (13, 29, channels), dtype=np.uint8)
    starts = np.array([[0, 0], [3, 7], [12, 28], [5, 0]], np.int32)
    offsets = region.band_offsets(band.shape, starts)
    assert offsets.dtype == np.int64
    flat = band.ravel()
    for (y, x), o in zip(starts.tolist(), offsets.tolist()):
        np.testing.assert_array_equal(flat[o : o + channels], band[y, x])


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


def _pack_canvas(seed: int):
    """A 4-channel [np, hv0, hv1, tp] canvas and count whose normalised type
    values land on halves (2.5, 3.5, ...), so half-to-even rounding shows."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 4, (H, W, 1)).astype(np.float32)
    c = rng.random((H, W, 4), dtype=np.float32)
    c[..., 0] = np.where(rng.random((H, W)) < 0.2, 0.5, c[..., 0]) * np.maximum(count[..., 0], 1)
    c[..., 3] = rng.integers(0, 12, (H, W)).astype(np.float32) / 2 * np.maximum(count[..., 0], 1)
    return c, count


@pytest.mark.parametrize(("with_tp", "crop"), [(True, (H, W)), (True, (H - 3, W - 5)), (False, (H, W))])
def test_pack_fg_tp_equals_jax_block_fetch(with_tp: bool, crop) -> None:
    from types import SimpleNamespace

    from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
    from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor

    c, n = _pack_canvas(7)
    head_channels = [1, 2, 1] if with_tp else [1, 2]
    c = c if with_tp else c[..., :3].copy()
    h, w = crop
    block_fn = JaxSegmentor._make_normalized_block_fn(
        None,
        SimpleNamespace(canvas=jnp.asarray(c), count=jnp.asarray(n)),
        w,
        transform=lambda rows: JaxHoVerNet.block_fetch_transform(None, rows, head_channels),
    )
    want = np.asarray(block_fn(0, h))
    got, _ = canvas.pack_fg_tp(
        torch.from_numpy(c), torch.from_numpy(n), h, w, tp_channel=3 if with_tp else -1
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_fg_tp_rejects_bad_arguments() -> None:
    c, n = (torch.from_numpy(a) for a in _pack_canvas(1))
    with pytest.raises(ValueError, match="does not fit"):
        canvas.pack_fg_tp(c, n, H + 1, W)
    with pytest.raises(ValueError, match="outside"):
        canvas.pack_fg_tp(c, n, H, W, tp_channel=4)
    with pytest.raises(ValueError, match="no hv pair"):
        canvas.pack_fg_tp(c[..., :2].contiguous(), n, H, W)


def _type_canvas(tp_channel: int):
    """A 4-channel canvas whose normalised type channel runs from -3.6 to
    1000: rounded types below 0 and above 255, halves on both sides."""
    types = np.array([-3.6, -1.0, -0.6, -0.5, -0.4, 0.5, 2.5, 127.5, 254.6, 255.4, 255.5, 256.0, 300.0, 1000.0])
    rng = np.random.default_rng(5)
    count = rng.integers(0, 4, (H, W, 1)).astype(np.float32)
    c = rng.random((H, W, 4), dtype=np.float32) * np.maximum(count, 1)
    c[..., tp_channel] = rng.choice(types, (H, W)).astype(np.float32) * np.maximum(count[..., 0], 1)
    return c, count


def test_pack_fg_tp_saturates_types_outside_a_byte_as_jax() -> None:
    """A rounded type below 0 packs as 0 and one above 255 as 255 (then
    shifted: 254), as ``jnp.round(...).astype(jnp.uint8)`` in JAX's
    ``block_fetch_transform`` gives on the normalised block."""
    from types import SimpleNamespace

    from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet
    from tiatoolbox_tpu.models.engine.semantic_segmentor import SemanticSegmentor as JaxSegmentor

    c, n = _type_canvas(3)
    block_fn = JaxSegmentor._make_normalized_block_fn(
        None,
        SimpleNamespace(canvas=jnp.asarray(c), count=jnp.asarray(n)),
        W,
        transform=lambda rows: JaxHoVerNet.block_fetch_transform(None, rows, [1, 2, 1]),
    )
    want = np.asarray(block_fn(0, H))
    assert {0, 254} <= set(np.unique(want >> 1 << 1).tolist())
    got, _ = canvas.pack_fg_tp_reference(torch.from_numpy(c), torch.from_numpy(n), H, W, tp_channel=3)
    np.testing.assert_array_equal(got.numpy(), want)


def _hv_canvas(h: int, width: int, channels: int, seed: int, zero_counts: bool = False):
    """An accumulated ``[h, width, channels]`` canvas ([np, h, v(, tp, ...)])
    and its count (0 to 3, or all 0): hv of either sign times the count, so
    the normalised pair spans about [-1, 1]; no patch left 0 where the
    count is 0."""
    rng = np.random.default_rng(seed)
    count = np.zeros((h, width, 1), np.float32) if zero_counts else rng.integers(0, 4, (h, width, 1)).astype(np.float32)
    c = rng.random((h, width, channels), dtype=np.float32) * np.maximum(count, 1)
    c[..., 1:3] = rng.uniform(-1, 1, (h, width, 2)).astype(np.float32) * np.maximum(count, 1)
    if channels > 3:
        c[..., 3] = rng.integers(0, 6, (h, width)).astype(np.float32) * np.maximum(count[..., 0], 1)
    return c, count


# (canvas height, canvas width, channels, crop, zero counts): rows padded
# wider than the crop, ragged crops, one row, one pixel
HV_CASES = {
    "C=4 padded, ragged crop": (40, 52, 4, (37, 45), False),
    "C=3 padded, ragged crop": (40, 53, 3, (33, 50), False),
    "C=4 whole canvas": (24, 36, 4, (24, 36), False),
    "C=3 one row": (9, 47, 3, (1, 47), False),
    "C=4 one pixel": (5, 7, 4, (1, 1), False),
    "C=5 padded": (21, 30, 5, (20, 27), False),
    "C=4 zero counts": (16, 21, 4, (15, 21), True),
}


@pytest.mark.parametrize("name", list(HV_CASES))
def test_pack_hv_minmax_equals_jax_min_max_of_the_normalised_pair(name: str) -> None:
    """The min/max of ``pack_fg_tp_reference`` is ``jnp.min``/``jnp.max``
    of JAX's normalised hv (``normalize_canvas``, as HoVerNet's
    ``final_fetch_transform`` feeds ``hv_energy``), bit for bit; the plane
    is JAX's ``block_fetch_transform`` of the same normalised crop."""
    from tiatoolbox_tpu.models.architecture.hovernet import HoVerNet as JaxHoVerNet

    ch, cw, channels, (h, w), zero = HV_CASES[name]
    c, n = _hv_canvas(ch, cw, channels, seed=len(name), zero_counts=zero)
    normalized = jax_canvas.normalize_canvas(jnp.asarray(c), jnp.asarray(n))[:h, :w]
    want = np.array(
        [jnp.min(normalized[..., 1]), jnp.max(normalized[..., 1]), jnp.min(normalized[..., 2]), jnp.max(normalized[..., 2])],
        np.float32,
    )
    tp = 3 if channels > 3 else -1
    want_plane = np.asarray(JaxHoVerNet.block_fetch_transform(None, normalized, [1, 2, 1] if tp == 3 else [1, 2]))
    for fn in (canvas.pack_fg_tp_reference, canvas.pack_fg_tp):
        plane, minmax = fn(torch.from_numpy(c), torch.from_numpy(n), h, w, tp)
        assert minmax.dtype == torch.float32 and tuple(minmax.shape) == (4,)
        np.testing.assert_array_equal(minmax.numpy().view(np.uint32), want.view(np.uint32))
        np.testing.assert_array_equal(plane.numpy(), want_plane)


def test_pack_hv_minmax_of_an_empty_crop() -> None:
    c, n = (torch.from_numpy(a) for a in _hv_canvas(8, 8, 4, seed=2))
    plane, minmax = canvas.pack_fg_tp(c, n, 0, 8, 3)
    assert tuple(plane.shape) == (0, 8, 1)
    assert minmax.tolist() == [float("inf"), float("-inf"), float("inf"), float("-inf")]


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
@pytest.mark.parametrize("channels", [1, 4, 5, 8, 11])
def test_scatter_kernel_matches_plain_version_at_any_channel_count(channels: int) -> None:
    """4 and 8 channels move as 16-byte words, 1-8 are fixed at compile time,
    and a thread carries up to 8 channels; more take a second group of threads."""
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


def _held_on_card(c0, n0, patches, pos, valid) -> int:
    """Scatter with the kernel and the plain version on the card; both must
    agree bit for bit. Returns the kernel's launches."""
    before = canvas.scatter_accumulate.launches
    got = canvas.scatter_accumulate(c0.clone(), n0.clone(), patches, pos, valid)
    want = canvas.scatter_accumulate_reference(c0.clone(), n0.clone(), patches, pos, valid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return canvas.scatter_accumulate.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [320, 319, 321, 800])
def test_scatter_kernel_across_parameter_table_chunks(n_valid: int) -> None:
    """A launch takes SCATTER_ENTRIES (320) entries: a chunk, one less, one
    more and 2.5 chunks of heavily overlapping 6x7 patches, so later chunks
    add to what earlier ones wrote; invalid entries sit between them."""
    _on_card()
    assert canvas.SCATTER_ENTRIES == 320
    rng = np.random.default_rng(n_valid)
    n = n_valid + 40
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    pos = rng.integers(0, [H - 6, W - 7], (n, 2)).astype(np.int32)
    patches = torch.from_numpy(rng.random((n, 6, 7, 4), dtype=np.float32)).cuda()
    c0 = torch.from_numpy(rng.random((H, W, 4), dtype=np.float32)).cuda()
    n0 = torch.zeros((H, W, 1), device="cuda")
    assert _held_on_card(c0, n0, patches, pos, valid) == -(-n_valid // 320)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [4, 5])
def test_scatter_kernel_on_a_mostly_uncovered_box(channels: int) -> None:
    """Patches at the corners of a 300x400 canvas: most tiles of the union
    box meet no patch and must leave the canvas untouched."""
    _on_card()
    rng = np.random.default_rng(channels)
    pos = np.array([[0, 0], [300 - 16, 400 - 16], [0, 400 - 16], [300 - 16, 0], [150, 190]], np.int32)
    patches = torch.from_numpy(rng.random((5, 16, 16, channels), dtype=np.float32)).cuda()
    c0 = torch.from_numpy(rng.random((300, 400, channels), dtype=np.float32)).cuda()
    n0 = torch.from_numpy(rng.integers(0, 3, (300, 400, 1)).astype(np.float32)).cuda()
    assert _held_on_card(c0, n0, patches, pos, np.ones(5, bool)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [4, 8])
def test_scatter_kernel_off_16_byte_boundaries(channels: int) -> None:
    """A canvas and patches 4 bytes past a 16-byte boundary take the scalar path."""
    _on_card()
    rng = np.random.default_rng(channels)
    flat_c = torch.from_numpy(rng.random(H * W * channels + 1, dtype=np.float32)).cuda()
    flat_p = torch.from_numpy(rng.random(6 * 16 * 16 * channels + 1, dtype=np.float32)).cuda()
    c0 = flat_c[1:].view(H, W, channels)
    patches = flat_p[1:].view(6, 16, 16, channels)
    pos = np.array([[0, 0], [4, 6], [8, 12], [H - 16, W - 16], [4, 6], [2, 9]], np.int32)
    assert _held_on_card(c0, torch.zeros((H, W, 1), device="cuda"), patches, pos, np.ones(6, bool)) == 1


@pytest.mark.cuda
def test_scatter_kernel_with_no_valid_entry_and_one_at_the_last_pixel() -> None:
    _on_card()
    rng = np.random.default_rng(9)
    patches = torch.from_numpy(rng.random((3, 16, 16, C), dtype=np.float32)).cuda()
    c0 = torch.from_numpy(rng.random((H, W, C), dtype=np.float32)).cuda()
    n0 = torch.ones((H, W, 1), device="cuda")
    pos = np.array([[0, 0], [4, 6], [H - 16, W - 16]], np.int32)
    assert _held_on_card(c0, n0, patches, pos, np.zeros(3, bool)) == 0
    assert _held_on_card(c0, n0, patches[2:].contiguous(), pos[2:], [True]) == 1


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


NORM_CROPS = [  # (y0, block_h, width): whole rows (one span), crops, one row, one column
    (0, 24, 37), (0, 24, 34), (5, 11, 37), (5, 11, 17), (23, 1, 37), (7, 1, 5), (3, 20, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("channels", list(range(1, 9)))
def test_normalize_kernel_at_any_channel_count_and_alignment_on_the_card(channels: int, dtype) -> None:
    """Rows of 37 pixels: row starts fall off 16-byte boundaries unless 4
    divides the channel count; a second canvas starts 4 bytes past one."""
    _on_card()
    rng = np.random.default_rng(channels)
    n = 24 * 37
    flat_c = torch.from_numpy(rng.random(n * channels + 1, dtype=np.float32)).cuda()
    flat_n = torch.from_numpy(rng.integers(0, 4, n + 1).astype(np.float32)).cuda()
    canvases = {
        "aligned": (flat_c[:-1].view(24, 37, channels), flat_n[:-1].view(24, 37, 1)),
        "4 bytes past": (flat_c[1:].view(24, 37, channels), flat_n[1:].view(24, 37, 1)),
    }
    for what, (c, cn) in canvases.items():
        for y0, bh, w in NORM_CROPS:
            before = canvas.normalize_rows.launches
            got = canvas.normalize_rows(c, cn, y0, bh, w, dtype)
            want = canvas.normalize_rows_reference(c, cn, y0, bh, w, dtype)
            torch.cuda.synchronize()
            assert canvas.normalize_rows.launches == before + 1
            assert torch.equal(got, want), (what, y0, bh, w)


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


def _extract_held_on_card(band, starts, patch_hw) -> int:
    """K4 and its plain version on the card, byte for byte; returns the launches."""
    before = region.extract_patches.launches
    got = region.extract_patches(band, starts, patch_hw)
    want = region.extract_patches_reference(band, starts, patch_hw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return region.extract_patches.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("byte_offset", list(range(16)))
def test_extract_kernel_at_every_start_byte_offset(byte_offset: int) -> None:
    """A band 45 pixels wide (135-byte rows, odd): patches whose first byte
    lies ``byte_offset`` bytes past a 16-byte boundary, 16x16 (48-byte rows)
    and 16x15 (45-byte rows)."""
    _on_card()
    band = torch.from_numpy(_band(byte_offset)).cuda()
    h, w, c = band.shape
    base = band.data_ptr()
    starts = [
        [y, x] for y in range(h - 16) for x in range(w - 16) if (base + (y * w + x) * c) % 16 == byte_offset
    ][:8]
    assert len(starts) == 8
    for pw in (16, 15):
        assert _extract_held_on_card(band, np.array(starts, np.int32), (16, pw)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize(("channels", "pw"), [(3, 15), (3, 7), (1, 13), (4, 4), (3, 45)])
def test_extract_kernel_with_rows_off_16_byte_words_to_the_bands_last_byte(channels: int, pw: int) -> None:
    """Patch rows of pw x C bytes, not a multiple of 16 (except 4x4), and a
    patch whose last byte is the band's last byte."""
    _on_card()
    band = torch.from_numpy(
        np.random.default_rng(pw).integers(0, 256, (37, 45, channels), dtype=np.uint8)
    ).cuda()
    starts = np.array([[0, 0], [3, 11], [37 - 9, 45 - pw], [20, 1]], np.int32)
    assert _extract_held_on_card(band, starts, (9, pw)) == 1


@pytest.mark.cuda
def test_extract_kernel_across_parameter_table_chunks() -> None:
    """A launch takes EXTRACT_PATCHES (500) patches: 1,101 take three."""
    _on_card()
    assert region.EXTRACT_PATCHES == 500
    band = torch.from_numpy(_band(7)).cuda()
    starts = np.random.default_rng(7).integers(0, [37 - 5, 45 - 6], (1101, 2)).astype(np.int32)
    assert _extract_held_on_card(band, starts, (5, 6)) == 3


def _held_fused_pack(c, n, crop, tp_channel: int, what: str) -> None:
    """K6 against its plain version on the card, bit for bit (the plane and
    the 4 floats of the hv min/max)."""
    before = canvas.pack_fg_tp.launches
    plane, minmax = canvas.pack_fg_tp(c, n, *crop, tp_channel)
    want_plane, want_minmax = canvas.pack_fg_tp_reference(c, n, *crop, tp_channel)
    torch.cuda.synchronize()
    assert canvas.pack_fg_tp.launches == before + 1, what
    assert torch.equal(plane, want_plane), what
    assert torch.equal(minmax.view(torch.int32), want_minmax.view(torch.int32)), (what, minmax, want_minmax)


@pytest.mark.cuda
@pytest.mark.parametrize(("channels", "tp_channel"), [(4, 3), (4, -1), (3, -1), (3, 0)])
def test_fused_pack_kernel_at_every_row_start_on_the_card(channels: int, tp_channel: int) -> None:
    """Canvas widths of every residue mod 4 (a row's first pixel at each
    place in a 16-byte word of the count, so the groups of 4 start after 0-3
    pixels), the canvas and count shifted together by 0-3 pixels (the
    vectorised path) and the canvas alone by one float (the scalar one),
    full, ragged, 1x1 and 1xw crops, and all-zero counts."""
    _on_card()
    h = 23
    for width in (40, 41, 42, 43):
        for zero in (False, True):
            c_np, n_np = _hv_canvas(h, width, channels, seed=width, zero_counts=zero)
            flat_c = torch.from_numpy(np.concatenate([c_np.ravel(), np.zeros(4 * channels, np.float32)])).cuda()
            flat_n = torch.from_numpy(np.concatenate([n_np.ravel(), np.zeros(4, np.float32)])).cuda()
            m = h * width
            shifts = {f"{s} pixels": (s * channels, s) for s in range(4)}
            shifts["canvas 1 float"] = (1, 0)
            for what, (oc, on) in shifts.items():
                c = flat_c[oc : oc + m * channels].view(h, width, channels)
                n = flat_n[on : on + m].view(h, width, 1)
                for crop in ((h, width), (h - 2, width - 5), (1, 1), (1, width), (h, 3)):
                    _held_fused_pack(c, n, crop, tp_channel, f"width {width} zero {zero} {what} crop {crop}")


@pytest.mark.cuda
def test_fused_pack_kernel_across_warp_items_on_the_card() -> None:
    """Rows of 1,000 to 2,051 pixels: several 128-pixel items a row, and
    more items than the persistent grid's warps at 300 rows."""
    _on_card()
    for width, crop in ((1003, (300, 1000)), (2051, (37, 2051))):
        c, n = (torch.from_numpy(a).cuda() for a in _hv_canvas(crop[0] + 2, width, 4, seed=width))
        _held_fused_pack(c, n, crop, 3, f"width {width}")


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("tp_channel", "crop"), [(3, (H, W)), (3, (H - 3, W - 5)), (-1, (H, W)), (3, (1, 1))]
)
def test_pack_kernel_matches_plain_version_on_the_card(tp_channel: int, crop) -> None:
    _on_card()
    c, n = (torch.from_numpy(a).cuda() for a in _pack_canvas(3))
    got, got_minmax = canvas.pack_fg_tp(c, n, *crop, tp_channel=tp_channel)
    want, want_minmax = canvas.pack_fg_tp_reference(c, n, *crop, tp_channel=tp_channel)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_minmax.view(torch.int32), want_minmax.view(torch.int32))


@pytest.mark.cuda
def test_pack_kernel_saturates_types_outside_a_byte_on_the_card() -> None:
    """Rounded types from -4 to 1000: in channel 3 of an aligned canvas (the
    vectorised path) and of the same canvas one float off (the scalar one),
    and in channel 0 where the canvas starts one float early (vectorised)."""
    _on_card()
    c, n = _type_canvas(3)
    flat = torch.from_numpy(np.concatenate([np.zeros(1, np.float32), c.ravel()])).cuda()
    for cv, tp_channel in ((torch.from_numpy(c).cuda(), 3), (flat[1:].view(H, W, 4), 3), (flat[: H * W * 4].view(H, W, 4), 0)):
        _held_fused_pack(cv, torch.from_numpy(n).cuda(), (H, W), tp_channel, f"tp {tp_channel}")
