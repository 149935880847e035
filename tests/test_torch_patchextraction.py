"""Patch extractors and bench config 2's path: the port against the JAX package.

Both packages read the same JPEG slide written by JAX's synth (its default
JPEG tiles at Q 90). The sliding-window and points extractors must give the
same locations and every patch equal, over the mask kinds (none, "otsu",
"morphological", an ndarray, a ``.npy`` path, a ``VirtualWSIReader``),
``min_mask_ratio``, ``within_bound``, the stride, and the points inputs
(``.npy``, ``.csv``, ``.json`` and an ndarray). Bench config 2
(``bench.py:640-667``: the morphological mask at 8 mpp, then 224^2 patches
at stride 224 and 0.5 mpp with ``min_mask_ratio`` 0.1) runs at 2048x1536
through both packages; and at the smoke's 4096x3072 on the port's own
slide, whose patch count ``chip_smoke.py`` pins (the port's codec is
deterministic, so the card must count the same).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from tiatoolbox_tpu.data.synth import make_synthetic_slide as jax_make_slide
from tiatoolbox_tpu.tools import patchextraction as jax_pe
from tiatoolbox_tpu.utils import misc as jax_misc
from tiatoolbox_tpu.wsicore.wsireader import VirtualWSIReader as JaxVirtualReader
from tiatoolbox_tpu.wsicore.wsireader import WSIReader as JaxReader
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide
from tiatoolbox_tpu_torch.tools import patchextraction as port_pe
from tiatoolbox_tpu_torch.utils import misc as port_misc
from tiatoolbox_tpu_torch.wsicore.wsireader import VirtualWSIReader as PortVirtualReader
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader as PortReader

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CONFIG2 = dict(
    patch_size=(224, 224), stride=(224, 224), resolution=0.5, units="mpp", min_mask_ratio=0.1
)


@pytest.fixture(scope="module")
def slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("pe") / "slide.tiff"
    jax_make_slide(path, size=(768, 512), mpp=0.5, objective_power=20, tile_size=128, seed=51)
    return str(path)


def _locations(extractor) -> np.ndarray:
    df = extractor.locations_df
    return np.stack([np.asarray(df["x"]), np.asarray(df["y"])], axis=1)


def _assert_same_extraction(jax_ext, port_ext) -> int:
    assert len(port_ext) == len(jax_ext)
    np.testing.assert_array_equal(_locations(port_ext), _locations(jax_ext))
    n = 0
    for got, want in zip(port_ext, jax_ext):
        np.testing.assert_array_equal(got, want)
        n += 1
    assert n == len(jax_ext)
    for item in (0, len(jax_ext) - 1):
        if len(jax_ext):
            np.testing.assert_array_equal(port_ext[item], jax_ext[item])
    return n


def _mask_pair(kind: str, slide: str, tmp_path: Path):
    if kind in ("none", "otsu", "morphological"):
        return (None, None) if kind == "none" else (kind, kind)
    thumb_mask = JaxReader.open(slide).tissue_mask(resolution=2.5, units="power").img
    if kind == "ndarray":
        return thumb_mask, thumb_mask
    if kind == "npy":
        path = tmp_path / "mask.npy"
        np.save(path, thumb_mask)
        return str(path), str(path)
    info_j, info_p = JaxReader.open(slide).info, PortReader.open(slide).info
    return (
        JaxVirtualReader(thumb_mask, info=info_j, mode="bool"),
        PortVirtualReader(thumb_mask, info=info_p, mode="bool"),
    )


@pytest.mark.parametrize("mask", ["none", "otsu", "morphological", "ndarray", "npy", "reader"])
@pytest.mark.parametrize(
    ("ratio", "within_bound", "stride"),
    [(0.0, False, None), (0.5, True, (100, 150)), (0.1, False, 224)],
)
def test_sliding_window_matches_jax(slide, tmp_path, mask, ratio, within_bound, stride) -> None:
    jax_mask, port_mask = _mask_pair(mask, slide, tmp_path)
    kwargs = dict(
        patch_size=(160, 128),
        resolution=0.5,
        units="mpp",
        stride=stride,
        min_mask_ratio=ratio,
        within_bound=within_bound,
    )
    jax_ext = jax_pe.get_patch_extractor("slidingwindow", input_img=slide, input_mask=jax_mask, **kwargs)
    port_ext = port_pe.get_patch_extractor(
        "slidingwindow", input_img=slide, input_mask=port_mask, **kwargs
    )
    np.testing.assert_array_equal(port_ext.coordinate_list, jax_ext.coordinate_list)
    _assert_same_extraction(jax_ext, port_ext)


POINTS = np.array([[10, 20, 0], [300, 200, 1], [767, 511, 2], [400, 90, 1], [-30, 600, 0]])


@pytest.mark.parametrize("source", ["ndarray", "ndarray2", "npy", "csv", "csv_no_header", "json"])
def test_points_extractor_matches_jax(slide, tmp_path, source) -> None:
    if source == "ndarray":
        table = POINTS
    elif source == "ndarray2":
        table = POINTS[:, :2].copy()
    elif source == "npy":
        table = str(tmp_path / "points.npy")
        np.save(table, POINTS)
    elif source == "csv":
        table = str(tmp_path / "points.csv")
        Path(table).write_text("x,y,class\n" + "".join(f"{x},{y},{c}\n" for x, y, c in POINTS))
    elif source == "csv_no_header":
        table = str(tmp_path / "points.csv")
        Path(table).write_text("".join(f"{x},{y}\n" for x, y, _ in POINTS))
    else:
        table = str(tmp_path / "points.json")
        records = [{"x": int(x), "y": int(y), "class": int(c)} for x, y, c in POINTS]
        Path(table).write_text(json.dumps(records))
    kwargs = dict(patch_size=(64, 48), resolution=0, units="level")
    jax_ext = jax_pe.get_patch_extractor("point", input_img=slide, locations_list=table, **kwargs)
    port_ext = port_pe.get_patch_extractor("point", input_img=slide, locations_list=table, **kwargs)
    _assert_same_extraction(jax_ext, port_ext)
    want = jax_misc.read_locations(table)
    got = port_misc.read_locations(table)
    assert got.columns == list(want.columns)
    for column in want.columns:
        np.testing.assert_array_equal(got[column], want[column].to_numpy())


def test_unknown_method_and_bad_tables_raise(slide) -> None:
    from tiatoolbox_tpu_torch.utils import exceptions as port_exceptions

    # the port's one MethodNotSupportedError, as JAX's extractor raises its
    # utils.exceptions class
    assert port_pe.MethodNotSupportedError is port_exceptions.MethodNotSupportedError
    with pytest.raises(port_exceptions.MethodNotSupportedError, match="fixedwindow method"):
        port_pe.get_patch_extractor("fixedwindow", input_img=slide, patch_size=8)
    with pytest.raises(ValueError, match="x, y"):
        port_misc.read_locations(np.zeros((3, 4)))
    with pytest.raises(TypeError):
        port_misc.read_locations(3)


def _config2(pe, reader_cls, path: str):
    wsi = reader_cls.open(path)
    mask = wsi.tissue_mask(method="morphological", resolution=8.0, units="mpp")
    return pe.get_patch_extractor("slidingwindow", input_img=wsi, input_mask=mask, **CONFIG2)


def test_config2_path_matches_jax(tmp_path) -> None:
    """Bench config 2 at 2048x1536 on JAX's JPEG slide: the same mask, the
    same patch count and every patch equal."""
    path = tmp_path / "config2.tiff"
    jax_make_slide(path, size=(2048, 1536), mpp=0.5, objective_power=20)
    jax_ext, port_ext = _config2(jax_pe, JaxReader, str(path)), _config2(port_pe, PortReader, str(path))
    np.testing.assert_array_equal(port_ext.mask.img, jax_ext.mask.img)
    assert _assert_same_extraction(jax_ext, port_ext) > 0


def test_config2_count_on_the_smoke_slide(tmp_path) -> None:
    """The smoke's mask_extract phase: the port's own 4096x3072 JPEG slide
    (seed 11, Q 90) and the port alone. chip_smoke.py must count the same."""
    path = make_synthetic_slide(
        tmp_path / "mask_extract.tiff", size=chip_smoke.SLIDE_WH, mpp=0.5, objective_power=20
    )
    extractor = _config2(port_pe, PortReader, str(path))
    assert len(extractor) == chip_smoke.MASK_EXTRACT_PATCHES
    first = extractor[0]
    assert first.shape == (224, 224, 3) and first.dtype == np.uint8
