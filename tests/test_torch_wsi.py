"""Slide reading, tissue masks and resizing: the port against the JAX package.

Slides written by either package's deflate or JPEG writer must read back
pixel for pixel the same through both readers, at every pyramid level and
at resolutions that are integer downscales of a level; JPEG tiles also
through each of the port's decode paths (the region's native batch, one
tile at a time, and tiles prefetched for many regions at once). The port's
JPEG writer writes the JAX writer's file byte for byte. The native LZW and
PackBits decoders equal the Python ones, and a malformed stream falls back
to them as in JAX. Tissue masks (Otsu and
morphological) must be identical: the port reproduces OpenCV's greyscale,
structuring element and dilation anchor. ``imresize`` must equal OpenCV's
``INTER_AREA`` for integer downscales and ``INTER_NEAREST``; area at other
factors is held to one grey level, because OpenCV's general area path
accumulates in float32 and the port in float64.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from pathlib import Path

from tiatoolbox_tpu import native as jax_native
from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.tools import tissuemask as jax_tissuemask
from tiatoolbox_tpu.utils import transforms as jax_transforms
from tiatoolbox_tpu.wsicore import tiffio as jax_tiffio
from tiatoolbox_tpu.wsicore.wsireader import VirtualWSIReader as JaxVirtualReader
from tiatoolbox_tpu.wsicore.wsireader import WSIReader as JaxReader
from tiatoolbox_tpu_torch import native as port_native
from tiatoolbox_tpu_torch.data import synth as port_synth
from tiatoolbox_tpu_torch.tools import tissuemask as port_tissuemask
from tiatoolbox_tpu_torch.utils import transforms as port_transforms
from tiatoolbox_tpu_torch.wsicore import tiffio as port_tiffio
from tiatoolbox_tpu_torch.wsicore.wsireader import VirtualWSIReader as PortVirtualReader
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader as PortReader


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's tests; the setting is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SIZE = (640, 448)  # width, height


def _pyramid(base: np.ndarray, levels: int) -> list[np.ndarray]:
    images = [base]
    for _ in range(levels - 1):
        prev = images[-1]
        images.append(
            cv2.resize(prev, (prev.shape[1] // 2, prev.shape[0] // 2), interpolation=cv2.INTER_AREA)
        )
    return images


@pytest.fixture(scope="module")
def jax_slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("wsi") / "jax_deflate.tiff"
    base = synthetic_he_patch(SIZE, seed=31)
    description = (
        f"Aperio Image Library v0.0.0\n{SIZE[0]}x{SIZE[1]} (128x128) "
        "Deflate/RGB|AppMag = 20|MPP = 0.5"
    )
    jax_tiffio.TiffPyramidWriter(
        path, tile_size=128, description=description, mpp=(0.5, 0.5), compression="deflate"
    ).write(_pyramid(base, 3))
    return str(path)


@pytest.fixture(scope="module")
def port_slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("wsi") / "port_deflate.tiff"
    port_synth.make_synthetic_slide(
        path, size=SIZE, tile_size=128, seed=32, compression="deflate"
    )
    return str(path)


READS = [
    ("rect", (0, 0), (200, 150), 0, "level"),
    ("rect", (100, 60), (128, 128), 1, "level"),
    ("rect", (500, 300), (100, 100), 2, "level"),
    ("rect", (-40, -20), (96, 80), 0, "level"),
    ("rect", (64, 32), (100, 90), 1.0, "mpp"),
    ("rect", (64, 32), (60, 50), 4.0, "mpp"),
    ("rect", (32, 16), (90, 70), 5.0, "power"),
    ("bounds", (0, 0, 640, 448), None, 2, "level"),
    ("bounds", (40, 40, 424, 296), None, 1.0, "mpp"),
    ("bounds", (0, 0, 640, 448), None, 1.25, "power"),
    ("bounds", (600, 400, 700, 500), None, 0, "level"),
]


@pytest.fixture(scope="module")
def jax_jpeg_slide(tmp_path_factory) -> str:
    """JAX's JPEG writer (cv2, its default compression) at Q 70, with a real
    Aperio description; 640x448 at 128-pixel tiles, 3 levels."""
    path = tmp_path_factory.mktemp("wsi") / "jax_jpeg.tiff"
    base = synthetic_he_patch(SIZE, seed=34)
    description = (
        f"Aperio Image Library v12.0.5\n{SIZE[0]}x{SIZE[1]} [0,100 {SIZE[0]}x{SIZE[1]}] "
        "(128x128) JPEG/RGB Q=70|AppMag = 20|StripeWidth = 2040|MPP = 0.5"
    )
    jax_tiffio.TiffPyramidWriter(
        path, tile_size=128, description=description, mpp=(0.5, 0.5), jpeg_quality=70
    ).write(_pyramid(base, 3))
    return str(path)


@pytest.fixture(scope="module")
def port_jpeg_slide(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("wsi") / "port_jpeg.tiff"
    port_synth.make_synthetic_slide(path, size=SIZE, tile_size=128, seed=35)
    return str(path)


SLIDES = ["jax_slide", "port_slide", "jax_jpeg_slide", "port_jpeg_slide"]


@pytest.mark.parametrize("read", READS, ids=[f"{r[0]}-{r[3]}{r[4]}-{i}" for i, r in enumerate(READS)])
@pytest.mark.parametrize("which", SLIDES)
def test_reads_match_jax_reader(read, which, request) -> None:
    path = request.getfixturevalue(which)
    kind, loc, size, res, units = read
    jax_reader, port_reader = JaxReader.open(path), PortReader.open(path)
    if kind == "rect":
        want = jax_reader.read_rect(loc, size, resolution=res, units=units)
        got = port_reader.read_rect(loc, size, resolution=res, units=units)
    else:
        want = jax_reader.read_bounds(loc, resolution=res, units=units)
        got = port_reader.read_bounds(loc, resolution=res, units=units)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", SLIDES)
def test_metadata_and_resolution_frame_reads_match(which, request) -> None:
    path = request.getfixturevalue(which)
    jax_reader, port_reader = JaxReader.open(path), PortReader.open(path)
    for key, want in jax_reader.info.as_dict().items():
        got = port_reader.info.as_dict()[key]
        if key == "mpp":
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        else:
            assert got == want, key
    kwargs = dict(resolution=0.5, units="mpp", coord_space="resolution")
    np.testing.assert_array_equal(
        port_reader.read_rect((224, 224), (224, 224), **kwargs),
        jax_reader.read_rect((224, 224), (224, 224), **kwargs),
    )
    assert port_reader.slide_dimensions(1.0, "mpp") == jax_reader.slide_dimensions(1.0, "mpp")


VIRTUAL_READS = [
    ("rect", (0, 0), (64, 48), 0, "level"),
    ("rect", (16, 8), (32, 32), 1.0, "baseline"),
    ("rect", (10, 10), (20, 15), 0.5, "baseline"),
    ("rect", (-6, 90), (30, 30), 1.0, "baseline"),
    ("bounds", (0, 0, 128, 96), None, 0.5, "baseline"),
    ("bounds", (-8, -8, 40, 40), None, 1.0, "baseline"),
    ("bounds", (32, 16, 96, 80), None, 0.25, "baseline"),
]


@pytest.mark.parametrize(
    "read", VIRTUAL_READS, ids=[f"{r[0]}-{r[3]}{r[4]}-{i}" for i, r in enumerate(VIRTUAL_READS)]
)
@pytest.mark.parametrize("mode", ["rgb", "bool"])
def test_virtual_reader_matches_jax(read, mode) -> None:
    """Array-backed reads, as tissue masks are read: RGB at integer
    downscales, and boolean masks with a donor slide's metadata."""
    kind, loc, size, res, units = read
    rgb = synthetic_he_patch((128, 96), seed=33)
    if mode == "rgb":
        jax_reader, port_reader = JaxVirtualReader(rgb), PortVirtualReader(rgb)
    else:
        mask = (rgb[..., 0] < 200).astype(np.uint8)[::4, ::4]
        info = PortVirtualReader(rgb).info
        jax_reader = JaxVirtualReader(mask, info=JaxVirtualReader(rgb).info, mode="bool")
        port_reader = PortVirtualReader(mask, info=info, mode="bool")
    if kind == "rect":
        want = jax_reader.read_rect(loc, size, resolution=res, units=units)
        got = port_reader.read_rect(loc, size, resolution=res, units=units)
    else:
        want = jax_reader.read_bounds(loc, resolution=res, units=units)
        got = port_reader.read_bounds(loc, resolution=res, units=units)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_codecs_match_jax() -> None:
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 4, 3000, dtype=np.uint8))
    packed = _packbits_encode(data)
    assert port_tiffio._packbits_decode(packed) == jax_tiffio._packbits_decode(packed) == data
    lzw = _lzw_encode(data)
    assert port_tiffio._lzw_decode(lzw) == jax_tiffio._lzw_decode(lzw) == data


@pytest.mark.parametrize("which", SLIDES)
def test_tissue_masks_match_jax(which, request) -> None:
    path = request.getfixturevalue(which)
    jax_reader, port_reader = JaxReader.open(path), PortReader.open(path)
    np.testing.assert_array_equal(port_reader.tissue_mask().img, jax_reader.tissue_mask().img)
    thumb = jax_reader.slide_thumbnail(resolution=2.5, units="power")
    np.testing.assert_array_equal(
        port_tissuemask.OtsuTissueMasker().fit_transform([thumb]),
        jax_tissuemask.OtsuTissueMasker().fit_transform([thumb]),
    )
    for kwargs in ({"power": 2.5}, {"kernel_size": 4}, {"kernel_size": 3, "min_region_size": 30}):
        np.testing.assert_array_equal(
            port_tissuemask.MorphologicalMasker(**kwargs).fit_transform([thumb]),
            jax_tissuemask.MorphologicalMasker(**kwargs).fit_transform([thumb]),
        )


JPEG_READS = [
    ("rect", (0, 0), (640, 448), 0, "level"),  # every tile of level 0, edge tiles included
    ("rect", (0, 0), (320, 224), 1, "level"),
    ("rect", (0, 0), (160, 112), 2, "level"),
    ("rect", (120, 120), (16, 16), 0, "level"),  # one tile
    ("rect", (500, 380), (200, 100), 0, "level"),  # past the edge
    ("rect", (-50, -30), (120, 90), 1, "level"),
    ("rect", (700, 500), (32, 32), 0, "level"),  # wholly outside
    ("bounds", (100, 50, 612, 440), None, 1.0, "mpp"),
    ("bounds", (0, 0, 640, 448), None, 2.5, "power"),
]


@pytest.mark.parametrize(
    "read", JPEG_READS, ids=[f"{r[0]}-{r[3]}{r[4]}-{i}" for i, r in enumerate(JPEG_READS)]
)
@pytest.mark.parametrize("path_kind", ["batch", "per_tile", "prefetched"])
def test_jpeg_reads_match_jax_on_every_path(jax_jpeg_slide, read, path_kind) -> None:
    kind, loc, size, res, units = read
    jax_reader, port_reader = JaxReader.open(jax_jpeg_slide), PortReader.open(jax_jpeg_slide)
    if kind == "rect":
        want = jax_reader.read_rect(loc, size, resolution=res, units=units)
        bounds = (*loc, loc[0] + size[0], loc[1] + size[1])
    else:
        want = jax_reader.read_bounds(loc, resolution=res, units=units)
        bounds = loc
    port_tiffio.reset_decode_counts()
    if path_kind == "per_tile":
        port_reader.tiff._batch_decode_tiles = lambda *args: None
    elif path_kind == "prefetched":
        baseline = port_reader.bounds_at_resolution_to_baseline(bounds, res, units)
        port_reader.prefetch_bounds([baseline], res, units)
        prefetched = port_tiffio.decode_counts["batch"]
    if kind == "rect":
        got = port_reader.read_rect(loc, size, resolution=res, units=units)
    else:
        got = port_reader.read_bounds(loc, resolution=res, units=units)
    np.testing.assert_array_equal(got, want)
    counts = port_tiffio.decode_counts
    if path_kind == "per_tile":
        assert counts["batch"] == 0
    elif path_kind == "prefetched" and prefetched:
        assert counts["batch"] == prefetched and counts["single"] == 0


@pytest.mark.parametrize("level", [0, 1, 2])
def test_jpeg_tiles_match_jax_per_tile_and_batch(jax_jpeg_slide, level) -> None:
    """Every tile of a level through the port's per-tile decode, its batch
    decode and JAX's per-tile (cv2) and batch (libjpeg) decodes."""
    port, jax = port_tiffio.TiffFile(jax_jpeg_slide), jax_tiffio.TiffFile(jax_jpeg_slide)
    page_index = port.pyramid_pages()[level]
    page, jax_page = port.pages[page_index], jax.pages[page_index]
    shape = (page.tile_length, page.tile_width)
    indices = list(range(len(page.offsets)))
    batch = port._batch_decode_indices(page, indices)
    jax_batch = jax._batch_decode_indices(jax_page, indices)
    for idx in indices:
        single = port._decode_block_uncached(page, idx, shape)
        np.testing.assert_array_equal(single, jax._decode_block_uncached(jax_page, idx, shape))
        if len(indices) >= 2:
            np.testing.assert_array_equal(batch[idx], single)
            np.testing.assert_array_equal(jax_batch[idx], single)


def test_port_jpeg_writer_is_jax_writer(tmp_path) -> None:
    """The same levels through both writers give the same file, byte for
    byte, and each reader reads the other's slide."""
    levels = _pyramid(synthetic_he_patch((300, 200), seed=36), 2)
    description = "Aperio Image Library v0.0.0\n300x200 (128x128) JPEG/RGB Q=90|AppMag = 20|MPP = 0.5"
    paths = {}
    for name, module in (("port", port_tiffio), ("jax", jax_tiffio)):
        paths[name] = tmp_path / f"{name}.tiff"
        module.TiffPyramidWriter(
            paths[name], tile_size=128, description=description, mpp=(0.5, 0.5)
        ).write(levels)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    want = JaxReader.open(paths["port"]).read_bounds((0, 0, 300, 200), resolution=0, units="level")
    got = PortReader.open(paths["jax"]).read_bounds((0, 0, 300, 200), resolution=0, units="level")
    np.testing.assert_array_equal(got, want)
    page = port_tiffio.TiffFile(paths["port"]).pages[0]
    assert (page.compression, page.photometric) == (port_tiffio.COMPRESSION_JPEG, 6)


@pytest.mark.parametrize(
    ("codec", "mpp", "power"),
    [("JPEG/RGB Q=70", 0.499, 20.0), ("JPEG/RGB Q=90", 0.5, 20.0), ("JPEG/YCC Q=80", 0.2525, 40.0)],
)
def test_aperio_jpeg_metadata_matches_jax(tmp_path, codec: str, mpp: float, power: float) -> None:
    """Aperio descriptions as scanners and JAX's synth write them."""
    path = tmp_path / "aperio.tiff"
    description = (
        f"Aperio Image Library v12.0.5\n200x100 [0,100 200x100] (128x128) {codec}"
        f"|AppMag = {power:g}|StripeWidth = 2040|MPP = {mpp}"
    )
    jax_tiffio.TiffPyramidWriter(path, tile_size=128, description=description).write(
        [synthetic_he_patch((200, 100), seed=37)]
    )
    port = port_tiffio.TiffFile(path).svs_metadata()
    assert port == jax_tiffio.TiffFile(path).svs_metadata()
    assert port == {"vendor": "aperio", "mpp": (mpp, mpp), "objective_power": power}


@pytest.mark.parametrize("path_kind", ["batch", "per_tile"])
def test_corrupt_jpeg_tile_raises_naming_it(jax_jpeg_slide, tmp_path, path_kind) -> None:
    data = bytearray(Path(jax_jpeg_slide).read_bytes())
    page = port_tiffio.TiffFile(jax_jpeg_slide).pages[0]
    data[page.offsets[5] : page.offsets[5] + 2] = b"\x00\x00"  # tile 5 loses its SOI
    broken = tmp_path / "broken.tiff"
    broken.write_bytes(bytes(data))
    reader = PortReader.open(broken)
    if path_kind == "per_tile":
        reader.tiff._batch_decode_tiles = lambda *args: None
    reader.read_rect((0, 0), (128, 128), resolution=0, units="level")  # tile 0 is whole
    with pytest.raises(ValueError, match="block 5 of page 0"):
        reader.read_rect((0, 0), (640, 448), resolution=0, units="level")


def test_native_tiff_codecs_match_python_and_fall_back() -> None:
    rng = np.random.default_rng(4)
    for n in (1, 300, 5000, 40000):
        data = bytes(rng.integers(0, 6, n, dtype=np.uint8))
        lzw, packed = _lzw_encode(data), _packbits_encode(data)
        assert port_native.lzw_decode(lzw, n) == port_tiffio._lzw_decode(lzw) == data
        assert port_native.packbits_decode(packed, n) == port_tiffio._packbits_decode(packed) == data
        assert jax_native.lzw_decode(lzw, n) == data
    # malformed LZW (a first code past the literals) and a PackBits overflow
    bad_lzw = bytes([0b10010110, 0b00000000, 0b0])
    assert port_native.lzw_decode(bad_lzw, 64) is None
    assert jax_native.lzw_decode(bad_lzw, 64) is None
    assert port_native.packbits_decode(b"\xf0\x07", 4) is None
    assert port_native.packbits_decode(b"\xf0\x07", 17) == b"\x07" * 17


def test_lzw_strip_falls_back_to_python_as_jax(tmp_path) -> None:
    """An LZW strip that overflows its block makes the native decoder give
    up; both readers then decode it in Python and keep the block's bytes."""
    expected = 48 * 32 * 3
    data = bytes(np.random.default_rng(8).integers(0, 4, expected + 500, dtype=np.uint8))
    strip = _lzw_encode(data)
    assert port_native.lzw_decode(strip, expected) is None
    path = tmp_path / "lzw.tiff"
    _write_stripped_tiff(path, 32, 48, strip, compression=port_tiffio.COMPRESSION_LZW)
    got = port_tiffio.TiffFile(path).read_region(0, (0, 0), (32, 48))
    want = jax_tiffio.TiffFile(path).read_region(0, (0, 0), (32, 48))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.frombuffer(data[:expected], np.uint8).reshape(48, 32, 3))


def _write_stripped_tiff(path, width: int, height: int, strip: bytes, compression: int) -> None:
    """A one-strip RGB uint8 classic TIFF holding ``strip``."""
    import struct

    entries = [
        (256, 4, 1, width),
        (257, 4, 1, height),
        (258, 3, 1, 8),
        (259, 3, 1, compression),
        (262, 3, 1, 2),
        (273, 4, 1, 8),
        (277, 3, 1, 3),
        (278, 4, 1, height),
        (279, 4, 1, len(strip)),
    ]
    ifd = 8 + len(strip)
    out = b"II*\x00" + struct.pack("<I", ifd) + strip + struct.pack("<H", len(entries))
    for tag, ftype, count, value in entries:
        if ftype == 3:
            out += struct.pack("<HHIHH", tag, ftype, count, value, 0)
        else:
            out += struct.pack("<HHII", tag, ftype, count, value)
    out += struct.pack("<I", 0)
    Path(path).write_bytes(out)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.bool_])
@pytest.mark.parametrize(
    ("in_hw", "out_wh", "interp", "max_diff"),
    [
        ((96, 128), (64, 48), "area", 0),
        ((96, 128), (32, 24), "area", 0),
        ((96, 128), (16, 12), "area", 0),
        ((90, 120), (40, 15), "area", 0),
        ((96, 128), (50, 37), "area", 1),
        ((96, 128), (50, 37), "nearest", 0),
        ((40, 30), (91, 77), "nearest", 0),
    ],
)
def test_imresize_matches_jax(in_hw, out_wh, interp, max_diff, dtype) -> None:
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (*in_hw, 3)).astype(dtype)
    want = jax_transforms.imresize(img, output_size=out_wh, interpolation=interp)
    got = port_transforms.imresize(img, output_size=out_wh, interpolation=interp)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(float), want.astype(float), atol=max_diff, rtol=1e-6)


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and (j + 1 >= len(data) or data[j + 1] != data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, early change), for the decoder test."""
    codes: list[tuple[int, int]] = []
    table = {bytes([i]): i for i in range(256)}
    bits, next_code = 9, 258
    codes.append((256, bits))
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], bits))
        table[wc] = next_code
        next_code += 1
        if next_code >= (1 << bits) and bits < 12:
            bits += 1
        if next_code >= 4094:
            codes.append((256, bits))
            table = {bytes([i]): i for i in range(256)}
            bits, next_code = 9, 258
        w = bytes([byte])
    if w:
        codes.append((table[w], bits))
    codes.append((257, bits))
    acc, n_bits, out = 0, 0, bytearray()
    for code, width in codes:
        acc = (acc << width) | code
        n_bits += width
        while n_bits >= 8:
            n_bits -= 8
            out.append((acc >> n_bits) & 255)
    if n_bits:
        out.append((acc << (8 - n_bits)) & 255)
    return bytes(out)
