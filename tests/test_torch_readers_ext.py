"""The port's slide readers on its own codecs, held to the JAX readers.

Each case writes one file with seeded data and reads it with both packages:
every region must be equal bit for bit, at several resolutions and units,
and ``info`` must match. OpenCV is used only on the reference side (to
encode the PNG, BMP and JPEG fixtures, and as the decoder the port's
``utils/imagecodec.py`` is held to).

- the codecs: PNG (every colour type, 8 and 16 bits, each filter type,
  Adam7, palette and tRNS), BMP (24 and 32 bits, both row orders, bit
  fields) and JPEG against ``cv2.imdecode`` in both of its modes, and the
  formats and features they refuse;
- MIRAX from ``tests/mirax_synth.py``, with the adversarial containers of
  ``test_mirax_adversarial.py`` (overlap, fill colour, several data files,
  a missing data file, a corrupt tile);
- DICOM from JAX's ``make_synthetic_dicom`` (explicit and implicit VR,
  sparse, concatenated) and JPEG-encapsulated instances (with and without
  a Basic Offset Table);
- zarr and NGFF stores, with equal ``Zattrs``;
- fsspec references from both ``tiff_to_fsspec`` and reads through them,
  from a local file, a ``file://`` URL and an ``http.server`` on 127.0.0.1;
- PNG, JPEG and BMP slides through ``WSIReader.open``;
- ``MultichannelToRGB`` on a 5-channel TIFF with each XML colour scheme;
- the dispatch's refusals.
"""

from __future__ import annotations

import functools
import http.server
import json
import shutil
import struct
import threading
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from mirax_synth import write_synthetic_mrxs
from tiatoolbox_tpu.data import synth as jax_synth
from tiatoolbox_tpu.utils import magic as jax_magic
from tiatoolbox_tpu.utils.tiff_to_fsspec import tiff_to_fsspec as jax_tiff_to_fsspec
from tiatoolbox_tpu.wsicore import wsireader as jax_wsireader
from tiatoolbox_tpu.wsicore.metadata import ngff as jax_ngff
from tiatoolbox_tpu.wsicore.mirax import MiraxFile as JaxMiraxFile
from tiatoolbox_tpu.wsicore.store_reader import FsspecJsonWSIReader as JaxFsspecReader
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.data import synth as port_synth
from tiatoolbox_tpu_torch.utils import magic as port_magic
from tiatoolbox_tpu_torch.utils.exceptions import FileNotSupportedError
from tiatoolbox_tpu_torch.utils.imagecodec import imdecode
from tiatoolbox_tpu_torch.utils.misc import imread
from tiatoolbox_tpu_torch.utils.tiff_to_fsspec import tiff_to_fsspec as port_tiff_to_fsspec
from tiatoolbox_tpu_torch.wsicore import wsireader as port_wsireader
from tiatoolbox_tpu_torch.wsicore.metadata import ngff as port_ngff
from tiatoolbox_tpu_torch.wsicore.mirax import MiraxFile as PortMiraxFile
from tiatoolbox_tpu_torch.wsicore.store_reader import FsspecJsonWSIReader as PortFsspecReader
from tiatoolbox_tpu_torch.wsicore.store_reader import ReferenceMapper

# (resolution, units) pairs each slide is read at
READS = [(0, "level"), (1, "level"), (0.5, "mpp"), (1.0, "mpp"), (10, "power"), (0.5, "baseline")]


def _rgb(bgr: np.ndarray) -> np.ndarray:
    """cv2's BGR(A) output in RGB(A) order."""
    if bgr.ndim == 3 and bgr.shape[2] >= 3:
        return np.concatenate([bgr[..., 2::-1], bgr[..., 3:]], axis=-1)
    return bgr


def _info_equal(a, b) -> None:
    assert tuple(a.slide_dimensions) == tuple(b.slide_dimensions)
    assert [tuple(d) for d in a.level_dimensions] == [tuple(d) for d in b.level_dimensions]
    np.testing.assert_array_equal(a.level_downsamples, b.level_downsamples)
    assert a.level_count == b.level_count
    assert a.vendor == b.vendor
    if a.mpp is None:
        assert b.mpp is None
    else:
        np.testing.assert_array_equal(np.asarray(a.mpp, float), np.asarray(b.mpp, float))
    assert a.objective_power == b.objective_power


# A read at a fractional factor. The readers resize a region read at a
# level to its ``output_size`` with ``imresize``'s "optimise", which takes
# OpenCV's cubic there (JAX's rule), and cv2 runs Intel IPP's cubic wherever
# both sides are 4 pixels or more: the port reproduces it but for about one
# value in 10^5 (ROADMAP.md section 3). Such a read is held to a count of
# differing values, each one level apart; the count is each caller's
# ``fractional_differing``, 0 by default.
FRACTIONAL_READ = (0.4, "baseline")


def _reads_equal(jax_reader, port_reader, reads=READS, fractional_differing: int = 0) -> None:
    _info_equal(jax_reader.info, port_reader.info)
    w, h = port_reader.info.slide_dimensions
    differing = 0
    for resolution, units in [*reads, FRACTIONAL_READ]:
        pairs = []
        for loc, size in (((0, 0), (w, h)), ((w // 3 + 5, h // 4 + 3), (97, 61)), ((w - 40, h - 30), (64, 48))):
            want = jax_reader.read_rect(loc, size, resolution=resolution, units=units)
            got = port_reader.read_rect(loc, size, resolution=resolution, units=units)
            pairs.append((got, want, f"read_rect {loc} {size} {resolution} {units}"))
        bounds = (w // 5, h // 6, w // 5 + 120, h // 6 + 90)
        want = jax_reader.read_bounds(bounds, resolution=resolution, units=units)
        got = port_reader.read_bounds(bounds, resolution=resolution, units=units)
        pairs.append((got, want, f"read_bounds {resolution} {units}"))
        for got, want, what in pairs:
            if (resolution, units) != FRACTIONAL_READ:
                np.testing.assert_array_equal(got, want, err_msg=what)
                continue
            assert got.shape == want.shape and got.dtype == want.dtype, what
            diff = np.abs(got.astype(int) - want)
            assert diff.max(initial=0) <= 1, what
            differing += int(np.count_nonzero(diff))
    assert differing <= fractional_differing


# -- a PNG writer for the cases cv2 cannot write --------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Filter each row of ``rows`` (``[h, row_bytes]`` uint8) with the given types in turn."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - ((left + prev) >> 1)
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
            f = row - pred
        out.append(kind)
        out += (f & 255).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def png_bytes(
    samples: np.ndarray,
    ctype: int,
    depth: int = 8,
    *,
    kinds=(0, 1, 2, 3, 4),
    interlace: bool = False,
    palette: np.ndarray | None = None,
    trns: bytes | None = None,
) -> bytes:
    """A PNG of ``samples`` (``[h, w, channels]``, uint8 or uint16) written
    with the given filter types in turn, Adam7 if ``interlace``."""
    h, w, ch = samples.shape
    if depth == 16:
        raw = samples.astype(">u2").view(np.uint8).reshape(h, w, ch * 2)
    elif depth == 8:
        raw = samples.astype(np.uint8)
    else:  # sub-byte grey: pack bits
        per = 8 // depth
        packed = np.zeros((h, -(-w // per)), np.uint8)
        for x in range(w):
            packed[:, x // per] |= (samples[:, x, 0].astype(np.uint8) << (8 - depth * (x % per + 1))).astype(np.uint8)
        raw = packed[:, :, None]
    bpp = max(1, ch * depth // 8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    data = b""
    for x0, y0, dx, dy in passes if interlace else ((0, 0, 1, 1),):
        sub = raw[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(sub.reshape(sub.shape[0], -1), bpp, kinds)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    out += _chunk(b"tEXt", b"Comment\x00seeded")
    return out + _chunk(b"IDAT", zlib.compress(data, 9)) + _chunk(b"IEND", b"")


def _cv2_pair(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    return cv2.imdecode(buf, cv2.IMREAD_UNCHANGED), cv2.imdecode(buf, cv2.IMREAD_COLOR)


def _held_to_cv2(data: bytes) -> None:
    unchanged, color = _cv2_pair(data)
    assert unchanged is not None and color is not None
    got = imdecode(data, "unchanged")
    assert got.dtype == unchanged.dtype and got.shape == unchanged.shape
    np.testing.assert_array_equal(got, _rgb(unchanged))
    np.testing.assert_array_equal(imdecode(data, "color"), _rgb(color))


PNG_CASES = []
for _ctype, _ch in ((0, 1), (2, 3), (4, 2), (6, 4)):
    for _depth in (8, 16):
        for _interlace in (False, True):
            PNG_CASES.append((_ctype, _ch, _depth, _interlace))


@pytest.mark.parametrize(("ctype", "channels", "depth", "interlace"), PNG_CASES)
def test_png_colour_types_filters_and_adam7(ctype, channels, depth, interlace) -> None:
    rng = np.random.default_rng(ctype * 100 + depth + interlace)
    top = 65536 if depth == 16 else 256
    # smooth plus noise, so each filter type changes the bytes
    yy, xx = np.mgrid[0:37, 0:29]
    base = ((yy * 7 + xx * 5)[..., None] * (top // 256)) % top
    samples = (base + rng.integers(0, top // 16, (37, 29, channels))) % top
    samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
    for kinds in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        _held_to_cv2(png_bytes(samples, ctype, depth, kinds=kinds, interlace=interlace))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("with_trns", [False, True])
def test_png_palette_and_transparency(interlace, with_trns) -> None:
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
    index = rng.integers(0, 40, (23, 31, 1), dtype=np.uint8)
    trns = bytes(rng.integers(0, 256, 25, dtype=np.uint8)) if with_trns else None
    _held_to_cv2(png_bytes(index, 3, 8, palette=palette, trns=trns, interlace=interlace))
    # an RGB colour key and a grey tRNS
    rgb = rng.integers(0, 4, (19, 17, 3), dtype=np.uint8)
    _held_to_cv2(png_bytes(rgb, 2, 8, trns=struct.pack(">HHH", 1, 2, 3), interlace=interlace))
    grey = rng.integers(0, 4, (19, 17, 1), dtype=np.uint8)
    _held_to_cv2(png_bytes(grey, 0, 8, trns=struct.pack(">H", 2), interlace=interlace))


@pytest.mark.parametrize("image", ["grey8", "grey16", "rgb8", "rgb16", "rgba8", "rgba16"])
def test_png_from_cv2(image) -> None:
    rng = np.random.default_rng(3)
    dtype = np.uint16 if image.endswith("16") else np.uint8
    ch = {"grey": 1, "rgb": 3, "rgba": 4}[image.rstrip("816")]
    arr = rng.integers(0, np.iinfo(dtype).max, (41, 53, ch), dtype=dtype)
    ok, buf = cv2.imencode(".png", arr[..., 0] if ch == 1 else arr)
    assert ok
    _held_to_cv2(buf.tobytes())


def _bmp(img: np.ndarray, *, top_down: bool, bpp: int) -> bytes:
    h, w = img.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    rows = range(h) if top_down else range(h - 1, -1, -1)
    body = b"".join(img[y, :, ::-1].tobytes().ljust(stride, b"\0") if bpp == 24 else
                    np.concatenate([img[y, :, 2::-1], img[y, :, 3:]], -1).tobytes().ljust(stride, b"\0")
                    for y in rows)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, len(body), 2835, 2835, 0, 0)
    return b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54) + info + body


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize(("bpp", "width"), [(24, 31), (24, 32), (32, 31)])
def test_bmp_rows(top_down, bpp, width) -> None:
    rng = np.random.default_rng(width + bpp)
    img = rng.integers(0, 256, (13, width, bpp // 8), dtype=np.uint8)
    _held_to_cv2(_bmp(img, top_down=top_down, bpp=bpp))


def test_bmp_bitfields_from_cv2() -> None:
    rng = np.random.default_rng(5)
    bgra = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    ok, buf = cv2.imencode(".bmp", bgra)
    assert ok
    _held_to_cv2(buf.tobytes())
    ok, buf = cv2.imencode(".bmp", bgra[..., :3])
    _held_to_cv2(buf.tobytes())


@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("grey", [False, True])
def test_jpeg_through_the_native_decoder(quality, grey) -> None:
    img = jax_synth.synthetic_he_patch((77, 45), seed=quality)
    data = native.encode_jpeg(img[..., 0] if grey else img, quality)
    _held_to_cv2(data)


def test_corrupt_and_refused_streams() -> None:
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    png = png_bytes(img, 2)
    garbage = b"\xde\xad\xbe\xef" * 16
    # no image, truncated, or a corrupt critical chunk: None, as cv2 gives
    at = len(png) - 20  # inside the IDAT chunk: its CRC no longer holds
    for data in (garbage, png[: len(png) // 2], png[:at] + bytes([png[at] ^ 0x55]) + png[at + 1 :]):
        assert imdecode(data) is None
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None
    jpeg = native.encode_jpeg(img, 90)
    assert imdecode(jpeg[: len(jpeg) - 40]) is None
    # features and formats the port's decoders lack raise, naming them
    ok, progressive = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(FileNotSupportedError, match="progressive"):
        imdecode(progressive.tobytes())
    with pytest.raises(FileNotSupportedError, match="1-bit"):
        imdecode(png_bytes(rng.integers(0, 2, (8, 9, 1), dtype=np.uint8), 0, 1))
    big = np.repeat(np.repeat(img, 8, axis=0), 8, axis=1)  # 128 pixels a side, for every encoder
    for ext, name in ((".tif", "TIFF"), (".webp", "WebP"), (".ppm", "PNM")):
        ok, buf = cv2.imencode(ext, big)
        assert ok
        with pytest.raises(FileNotSupportedError, match=name):
            imdecode(buf.tobytes())
    with pytest.raises(FileNotSupportedError, match="GIF"):
        imdecode(b"GIF89a" + bytes(20))
    with pytest.raises(FileNotSupportedError, match="8 bits per pixel"):
        ok, buf = cv2.imencode(".bmp", img[..., 0])
        imdecode(buf.tobytes())


@pytest.mark.parametrize("ext", [".png", ".jpg", ".bmp"])
def test_flat_images_through_wsireader_open(tmp_path, ext) -> None:
    img = jax_synth.synthetic_he_patch((300, 200), seed=9)
    path = tmp_path / f"flat{ext}"
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    from tiatoolbox_tpu.utils.misc import imread as jax_imread

    np.testing.assert_array_equal(imread(path), jax_imread(path))
    jax_reader = jax_wsireader.WSIReader.open(path, mpp=0.5)
    port_reader = port_wsireader.WSIReader.open(path, mpp=0.5)
    assert isinstance(port_reader, port_wsireader.VirtualWSIReader)
    _reads_equal(jax_reader, port_reader, reads=[(0, "level"), (0.5, "mpp"), (1.0, "mpp"), (0.5, "baseline")])
    np.save(tmp_path / "flat.npy", img)
    _reads_equal(
        jax_wsireader.WSIReader.open(tmp_path / "flat.npy"),
        port_wsireader.WSIReader.open(tmp_path / "flat.npy"),
        reads=[(0, "level"), (0.5, "baseline")],
    )


# -- MIRAX ---------------------------------------------------------------------


MIRAX_CASES = {
    "plain": {"grid_nx": 6, "grid_ny": 5, "n_levels": 3},
    "overlap": {"grid_nx": 4, "grid_ny": 3, "n_levels": 1, "overlap": 8},
    "fill": {"grid_nx": 3, "grid_ny": 2, "n_levels": 1, "missing_tiles": ((0, 1, 0),), "fill_bgr": 0x112233},
    "data_files": {"grid_nx": 4, "grid_ny": 3, "n_levels": 2, "n_data_files": 3},
    "corrupt": {"grid_nx": 3, "grid_ny": 3, "n_levels": 1, "corrupt_tiles": ((0, 1, 1),), "fill_bgr": 0x00FF00},
    "missing_data_file": {"grid_nx": 4, "grid_ny": 3, "n_levels": 1, "n_data_files": 2},
}


@pytest.mark.parametrize("case", list(MIRAX_CASES))
def test_mirax_against_jax(tmp_path, case) -> None:
    mrxs = write_synthetic_mrxs(tmp_path / "m", tile=64, **MIRAX_CASES[case])
    if case == "missing_data_file":
        (mrxs.parent / "m" / "Data0001.dat").unlink()
    jax_file, port_file = JaxMiraxFile(mrxs), PortMiraxFile(mrxs)
    for level in range(len(jax_file.levels)):
        assert port_file.level_dimensions(level) == jax_file.level_dimensions(level)
        assert port_file.fill_rgb(level) == jax_file.fill_rgb(level)
        w, h = jax_file.level_dimensions(level)
        for loc, size in (((0, 0), (w, h)), ((50, 7), (20, 32)), ((-10, -5), (w + 30, h + 9))):
            np.testing.assert_array_equal(
                port_file.read_region(level, loc, size), jax_file.read_region(level, loc, size)
            )
    assert port_file.read_associated(0) == jax_file.read_associated(0)
    reads = [(0, "level"), (0.5, "mpp"), (1.0, "mpp")] if len(jax_file.levels) > 1 else [(0, "level")]
    _reads_equal(jax_wsireader.WSIReader.open(mrxs), port_wsireader.WSIReader.open(mrxs), reads=reads,
                 fractional_differing={"plain": 8, "data_files": 5}.get(case, 0))


def test_mirax_refuses_a_tile_it_cannot_decode(tmp_path) -> None:
    mrxs = write_synthetic_mrxs(tmp_path / "p", grid_nx=2, grid_ny=1, tile=32, n_levels=1)
    data = mrxs.parent / "p" / "Data0000.dat"
    blob = data.read_bytes()
    ok, progressive = cv2.imencode(".jpg", np.full((32, 32, 3), 90, np.uint8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    first = blob.index(b"\xff\xd9") + 2  # the first tile's stream
    data.write_bytes(progressive.tobytes().ljust(first, b"\0") + blob[first:])
    index_path = mrxs.parent / "p" / "Index.dat"
    index = bytearray(index_path.read_bytes())
    # point the first tile's length at the progressive stream
    at = index.find(struct.pack("<iii", 0, 0, first))
    index[at + 8 : at + 12] = struct.pack("<i", len(progressive))
    index_path.write_bytes(bytes(index))
    with pytest.raises(FileNotSupportedError, match="progressive"):
        PortMiraxFile(mrxs).read_region(0, (0, 0), (64, 32))


# -- DICOM ---------------------------------------------------------------------


DICOM_CASES = {
    "explicit": {},
    "implicit": {"explicit": False},
    "sparse": {"sparse": True},
    "sparse_implicit": {"sparse": True, "explicit": False},
    "concatenated": {"n_concat": 3},
}


@pytest.mark.parametrize("case", list(DICOM_CASES))
def test_dicom_against_jax(tmp_path, case) -> None:
    folder = tmp_path / "dcm"
    folder.mkdir()
    out = jax_synth.make_synthetic_dicom(folder / "s.dcm", size=(400, 300), frame_size=96, seed=4, **DICOM_CASES[case])
    if isinstance(out, list):  # JAX's dispatch takes no DICOM directory: open it directly
        readers = jax_wsireader.DICOMWSIReader(folder), port_wsireader.DICOMWSIReader(folder)
    else:
        readers = jax_wsireader.WSIReader.open(out), port_wsireader.WSIReader.open(out)
    _reads_equal(
        *readers,
        reads=[(0, "level"), (0.5, "mpp"), (1.0, "mpp"), (20, "power")],
    )


@pytest.mark.parametrize("offset_table", [False, True])
def test_dicom_jpeg_frames(tmp_path, offset_table) -> None:
    img = jax_synth.synthetic_he_patch((333, 250), seed=8)
    folder = tmp_path / "pyr"
    folder.mkdir()
    port_synth.make_synthetic_dicom(folder / "l0.dcm", image=img, frame_size=128, compression="jpeg",
                                    offset_table=offset_table)
    half = cv2.resize(img, (166, 125), interpolation=cv2.INTER_AREA)
    port_synth.make_synthetic_dicom(folder / "l1.dcm", image=half, frame_size=128, mpp=1.0, compression="jpeg",
                                    offset_table=offset_table)
    # JAX decodes the frames with cv2, the port with its own decoder
    _reads_equal(jax_wsireader.DICOMWSIReader(folder), port_wsireader.DICOMWSIReader(folder),
                 reads=[(0, "level"), (1, "level"), (0.5, "mpp"), (1.0, "mpp")])
    port_frame = port_wsireader.WSIReader.open(folder / "l0.dcm").slide.levels[0].parts[0]
    assert len(port_frame.ds.frames) == 6


def test_dicom_frames_split_over_fragments(tmp_path) -> None:
    img = jax_synth.synthetic_he_patch((256, 128), seed=3)
    path = port_synth.make_synthetic_dicom(tmp_path / "f.dcm", image=img, frame_size=128, compression="jpeg")
    whole = port_wsireader.WSIReader.open(path).read_rect((0, 0), (256, 128))
    data = path.read_bytes()
    # cut every frame item into two fragments; the offset table stays empty
    start = data.index(struct.pack("<HH", 0x7FE0, 0x0010)) + 12
    items, pos = [], start + 8  # after the empty offset table item
    while struct.unpack_from("<HH", data, pos) == (0xFFFE, 0xE000):
        (n,) = struct.unpack_from("<I", data, pos + 4)
        frame = data[pos + 8 : pos + 8 + n]
        half = len(frame) // 2 & ~1
        items += [frame[:half], frame[half:]]
        pos += 8 + n
    split = b"".join(struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f for f in items)
    path.write_bytes(data[: start + 8] + split + data[pos:])
    np.testing.assert_array_equal(port_wsireader.WSIReader.open(path).read_rect((0, 0), (256, 128)), whole)


@pytest.mark.parametrize(("syntax", "name"), [(b"1.2.840.10008.1.2.4.80", "JPEG-LS"), (b"1.2.840.10008.1.2.4.70", "lossless"), (b"1.2.840.10008.1.2.5\x00", "RLE")])
def test_dicom_refuses_other_encapsulated_syntaxes(tmp_path, syntax, name) -> None:
    img = jax_synth.synthetic_he_patch((128, 128), seed=3)
    path = port_synth.make_synthetic_dicom(tmp_path / "j.dcm", image=img, frame_size=128, compression="jpeg")
    data = path.read_bytes().replace(b"1.2.840.10008.1.2.4.50", syntax.ljust(22, b"\x00")[:22], 1)
    path.write_bytes(data)
    with pytest.raises(FileNotSupportedError, match=name):
        port_wsireader.WSIReader.open(path).read_rect((0, 0), (64, 64))


# -- zarr and NGFF -------------------------------------------------------------


def _levels(img: np.ndarray, n: int) -> list[np.ndarray]:
    out = [img]
    for _ in range(n - 1):
        out.append(cv2.resize(out[-1], (out[-1].shape[1] // 2, out[-1].shape[0] // 2), interpolation=cv2.INTER_AREA))
    return out


@pytest.mark.parametrize("kind", ["zarr_group", "zarr_array", "ngff", "ngff_cyx"])
def test_zarr_and_ngff_against_jax(tmp_path, kind) -> None:
    from tiatoolbox_tpu_torch.utils.zarrlite import ZarrArray, ZarrGroup

    img = jax_synth.synthetic_he_patch((320, 240), seed=6)
    root = tmp_path / "s.zarr"
    if kind == "zarr_array":
        ZarrArray.from_array(root, img, chunks=(64, 64, 3))
    else:
        group = ZarrGroup.create(root)
        datasets = []
        for i, level in enumerate(_levels(img, 3)):
            data = np.moveaxis(level, -1, 0).copy() if kind == "ngff_cyx" else level
            group.from_array(str(i), data, chunks=(3, 64, 64) if kind == "ngff_cyx" else (64, 64, 3))
            scale = [0.5 * 2**i, 0.5 * 2**i, 1.0]
            datasets.append({"path": str(i), "coordinateTransformations": [{"type": "scale", "scale": scale}]})
        if kind.startswith("ngff"):
            names = ("c", "y", "x") if kind == "ngff_cyx" else ("y", "x", "c")
            axes = [{"name": n, "type": "channel" if n == "c" else "space", **({} if n == "c" else {"unit": "micrometer"})} for n in names]
            if kind == "ngff_cyx":
                datasets = [{**d, "coordinateTransformations": [{"type": "scale", "scale": [1.0, *d["coordinateTransformations"][0]["scale"][:2]]}]} for d in datasets]
            group.attrs = {"multiscales": [{"version": "0.4", "axes": axes, "datasets": datasets}],
                           "omero": {"channels": [{"label": "R", "color": "FF0000"}]}}
            jax_attrs = jax_ngff.Zattrs.from_dict(group.attrs).to_dict()
            port_attrs = port_ngff.Zattrs.from_dict(group.attrs).to_dict()
            assert port_attrs == jax_attrs
    assert port_magic.is_zarr(root) == jax_magic.is_zarr(root)
    assert port_magic.is_ngff(root) == jax_magic.is_ngff(root)
    jax_reader = jax_wsireader.WSIReader.open(root)
    port_reader = port_wsireader.WSIReader.open(root)
    assert type(port_reader).__name__ == type(jax_reader).__name__
    reads = [(0, "level"), (1, "level"), (0.25, "baseline")] if kind != "zarr_array" else [(0, "level")]
    if kind.startswith("ngff"):
        reads += [(0.5, "mpp"), (1.0, "mpp")]
    _reads_equal(jax_reader, port_reader, reads=reads, fractional_differing=0 if kind == "zarr_array" else 1)


def test_zattrs_defaults_name_the_port() -> None:
    z = port_ngff.Zattrs()
    assert z._creator.name == "tiatoolbox_tpu_torch"
    back = port_ngff.Zattrs.from_dict(z.to_dict())
    assert back.to_dict() == z.to_dict()
    jax_back = jax_ngff.Zattrs.from_dict(z.to_dict())
    assert jax_back.to_dict() == back.to_dict()


# -- fsspec references -----------------------------------------------------------


@pytest.fixture(scope="module")
def deflate_slide(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsspec")
    path = port_synth.make_synthetic_slide(root / "slide.tiff", size=(640, 480), tile_size=128, compression="deflate")
    return path


def _http_server(folder: Path):
    """A threaded ``http.server`` on 127.0.0.1 serving ``folder``, or None
    where the sandbox refuses the socket."""

    class RangeHandler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args) -> None:  # quiet
            return

        def send_head(self):
            rng = self.headers.get("Range")
            path = Path(self.translate_path(self.path))
            if rng is None or not path.is_file():
                return super().send_head()
            first, last = (int(v) for v in rng.split("=")[1].split("-"))
            data = path.read_bytes()[first : last + 1]
            self.send_response(206)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            import io

            return io.BytesIO(data)

    try:
        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(RangeHandler, directory=str(folder)))
    except OSError:
        return None
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.mark.parametrize("where", ["path", "file_url", "http"])
def test_fsspec_references_against_jax(deflate_slide, tmp_path, where) -> None:
    server = None
    if where == "http":
        server = _http_server(deflate_slide.parent)
        if server is None:
            pytest.skip("this sandbox refuses a socket on 127.0.0.1")
        url = f"http://127.0.0.1:{server.server_address[1]}/{deflate_slide.name}"
    elif where == "file_url":
        url = deflate_slide.resolve().as_uri()
    else:
        url = str(deflate_slide)
    try:
        jax_refs = jax_tiff_to_fsspec(deflate_slide, url, tmp_path / "jax.json")
        port_refs = port_tiff_to_fsspec(deflate_slide, url, tmp_path / "port.json")
        assert port_refs == jax_refs
        assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
        port_reader = PortFsspecReader(tmp_path / "port.json")
        tiff_reader = port_wsireader.WSIReader.open(deflate_slide)
        np.testing.assert_array_equal(port_reader.read_rect((0, 0), (640, 480)), tiff_reader.read_rect((0, 0), (640, 480)))
        if where != "http":  # fsspec's reference filesystem would fetch through aiohttp
            _reads_equal(JaxFsspecReader(tmp_path / "jax.json"), port_reader,
                         reads=[(0, "level"), (1, "level"), (0.25, "baseline")], fractional_differing=4)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()


def test_reference_mapper_values(tmp_path) -> None:
    blob = tmp_path / "blob.bin"
    blob.write_bytes(bytes(range(256)))
    import base64

    mapper = ReferenceMapper({
        "version": 1,
        "refs": {"a": "inline text", "b": "base64:" + base64.b64encode(b"\x00\x01zz").decode(),
                 "c": [str(blob), 10, 5], "d": [blob.as_uri()], "e": [blob.as_uri(), 250, 6]},
    })
    assert mapper["a"] == b"inline text" and mapper["b"] == b"\x00\x01zz"
    assert mapper["c"] == bytes(range(10, 15)) and mapper["d"] == bytes(range(256))
    assert mapper["e"] == bytes(range(250, 256))
    assert sorted(mapper) == ["a", "b", "c", "d", "e"] and "z" not in mapper
    with pytest.raises(ValueError, match="neither"):
        ReferenceMapper({"refs": {"bad": [1, 2]}})["bad"]


def test_fsspec_refuses_jpeg_tiles(tmp_path) -> None:
    path = port_synth.make_synthetic_slide(tmp_path / "j.tiff", size=(256, 256), tile_size=128)
    for fn in (jax_tiff_to_fsspec, port_tiff_to_fsspec):
        with pytest.raises(ValueError, match="Unsupported compression"):
            fn(path, "x")


# -- multiplex TIFFs --------------------------------------------------------------


def _scancolortable_xml() -> str:
    pairs = [("DAPI_1", "Blue"), ("FITC_2", "0, 255, 0"), ("Cy3_3", "Yellow"), ("Cy5_4", "Red"), ("AF_5", "lime")]
    kv = "".join(f"<ScanColorTable-k>{k}</ScanColorTable-k><ScanColorTable-v>{v}</ScanColorTable-v>" for k, v in pairs)
    return f"<PerkinElmer-QPI-ImageDescription><ScanColorTable>{kv}</ScanColorTable></PerkinElmer-QPI-ImageDescription>"


def _filtercolors_xml() -> str:
    filters = [("DAPI", "EX1", "EM1", "Cyan"), ("Opal520", "EX2", "EM2", "255,128,0"), ("Opal570", "EX3", "EM3", "Magenta"),
               ("Opal620", "EX4", "EM4", "Red"), ("Opal690", "EX5", "EM5", "White")]
    fc = "".join(f"<FilterColors-k>{ex} {em} pair</FilterColors-k><FilterColors-v>{col}</FilterColors-v>" for _, ex, em, col in filters)
    bands = "".join(
        f"<ScanBands-i><Bands-i><Name> {name} </Name></Bands-i><FilterPair><EmissionFilter><FixedFilter><PartNumber>{em}"
        f"</PartNumber></FixedFilter></EmissionFilter><ExcitationFilter><FixedFilter><PartNumber>{ex}</PartNumber>"
        f"</FixedFilter></ExcitationFilter></FilterPair></ScanBands-i>"
        for name, ex, em, _ in filters
    )
    return f"<Root><FilterColors>{fc}</FilterColors><ScanBands>{bands}</ScanBands></Root>"


def _ome_xml() -> str:
    colors = [-16776961, 16711935, 65535, -65281, 2139062271]
    chans = "".join(f'<Channel ID="Channel:0:{i}" Name="{"C" if i < 4 else "C"}{min(i, 3)}" Color="{c}"/>' for i, c in enumerate(colors))
    priv = "".join(f'<ChannelPriv ID="Channel:0:{i}" FluorescenceChannel="dye{i}"/>' for i in range(3))
    return (
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06"><Image ID="Image:0"><Pixels ID="Pixels:0">'
        f"{chans}</Pixels></Image><StructuredAnnotations><XMLAnnotation ID=\"A:0\"><Value>{priv}</Value>"
        "</XMLAnnotation></StructuredAnnotations></OME>"
    )


@pytest.mark.parametrize("scheme", ["scancolortable", "filtercolors", "ome", "none"])
def test_multichannel_tiff_against_jax(tmp_path, scheme) -> None:
    from tiatoolbox_tpu_torch.wsicore.tiffio import TiffPyramidWriter

    description = {"scancolortable": _scancolortable_xml, "filtercolors": _filtercolors_xml, "ome": _ome_xml,
                   "none": lambda: "plain"}[scheme]()
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (200, 160, 5), dtype=np.uint8)
    path = tmp_path / "mx.tiff"
    TiffPyramidWriter(path, tile_size=64, description=description, mpp=(0.5, 0.5), compression="deflate").write(
        [img, img[::2, ::2].copy()]
    )
    jax_reader = jax_wsireader.WSIReader.open(path)
    port_reader = port_wsireader.WSIReader.open(path)
    if scheme == "none":
        assert port_reader.post_proc.color_dict is None and jax_reader.post_proc.color_dict is None
    else:
        assert port_reader.post_proc.color_dict == jax_reader.post_proc.color_dict
        assert len(port_reader.post_proc.color_dict) == 5
    _reads_equal(jax_reader, port_reader, reads=[(0, "level"), (1, "level"), (0.5, "mpp")])
    assert port_reader.read_rect((0, 0), (32, 32)).shape == (32, 32, 3)
    # post_proc=None keeps the channels
    raw = port_wsireader.WSIReader.open(path, post_proc=None).read_rect((0, 0), (32, 32))
    np.testing.assert_array_equal(raw, img[:32, :32])


def test_color_strings_against_matplotlib() -> None:
    import matplotlib.colors as mcolors

    from tiatoolbox_tpu_torch.utils import colors

    assert colors.CSS4_COLORS == dict(mcolors.CSS4_COLORS)
    names = [*mcolors.CSS4_COLORS, *mcolors.BASE_COLORS, *mcolors.TABLEAU_COLORS, "Lime", "DarkOliveGreen", "#abc",
             "#a0b1c2", "#a0b1c2ff", "0.25"]
    for name in names:
        assert port_wsireader.TIFFWSIReader._color_string_to_rgb(name) == tuple(
            jax_wsireader.TIFFWSIReader._color_string_to_rgb(name)
        ), name
    assert port_wsireader.TIFFWSIReader._color_string_to_rgb("12, 34, 56") == (12 / 255, 34 / 255, 56 / 255)
    with pytest.raises(ValueError, match="Invalid"):
        colors.to_rgb("not a colour")


def test_multichannel_postproc_options() -> None:
    from tiatoolbox_tpu.utils import postproc_defs as jax_pp
    from tiatoolbox_tpu_torch.utils import postproc_defs as port_pp

    rng = np.random.default_rng(1)
    img16 = rng.integers(0, 65536, (20, 30, 6), dtype=np.uint16)
    for make in (lambda m: m.MultichannelToRGB(), lambda m: m.MultichannelToRGB({f"c{i}": (i / 7, 1 - i / 7, 0.5) for i in range(7)})):
        j, p = make(jax_pp), make(port_pp)
        j.enhance = p.enhance = 1.7
        np.testing.assert_array_equal(p(img16), j(img16))
        p.set_active_channels([0, 2])
        j.set_active_channels([0, 2])
        np.testing.assert_array_equal(p(img16), j(img16))
    rgb = rng.integers(0, 256, (4, 4, 3), dtype=np.uint8)
    assert port_pp.MultichannelToRGB()(rgb) is rgb
    with pytest.raises(ValueError, match="does not match"):
        port_pp.MultichannelToRGB({"a": (1, 0, 0)})(img16)


# -- dispatch ----------------------------------------------------------------------


def test_dispatch_and_refusals(tmp_path, deflate_slide) -> None:
    mrxs = write_synthetic_mrxs(tmp_path / "d", grid_nx=2, grid_ny=2, tile=32, n_levels=1)
    dcm = jax_synth.make_synthetic_dicom(tmp_path / "x.dcm", size=(128, 128), frame_size=64)
    (tmp_path / "plain.txt").write_text("not a slide")
    (tmp_path / "empty_dir").mkdir()
    for path, cls in ((mrxs, "MIRAXWSIReader"), (dcm, "DICOMWSIReader"), (deflate_slide, "TIFFWSIReader")):
        assert type(port_wsireader.WSIReader.open(path)).__name__ == cls
        assert type(jax_wsireader.WSIReader.open(path)).__name__ == cls
    files = [mrxs, dcm, deflate_slide, tmp_path / "plain.txt", tmp_path / "empty_dir"]
    for path in files:
        for name in ("is_zip", "is_dcm", "is_tiff", "is_jp2", "is_png", "is_jpeg", "is_dir", "is_zarr", "is_ngff", "is_sqlite3"):
            assert getattr(port_magic, name)(path) == getattr(jax_magic, name)(path), (name, path)
        assert port_wsireader.is_dicom(path) == jax_wsireader.is_dicom(path)
        assert port_wsireader.is_tiled_tiff(path) == jax_wsireader.is_tiled_tiff(path)
    assert isinstance(port_wsireader.OpenSlideWSIReader(mrxs), port_wsireader.MIRAXWSIReader)
    with pytest.raises(FileNotSupportedError, match="OpenSlideWSIReader covers"):
        port_wsireader.OpenSlideWSIReader(dcm)
    for bad, error in ((tmp_path / "plain.txt", FileNotSupportedError), (tmp_path / "empty_dir", FileNotSupportedError),
                       (tmp_path / "missing.svs", FileNotFoundError)):
        with pytest.raises(error):
            port_wsireader.WSIReader.open(bad)
        with pytest.raises(Exception) as jax_error:
            jax_wsireader.WSIReader.open(bad)
        assert type(jax_error.value).__name__ == error.__name__
    # JPEG 2000 and annotation stores open as in JAX
    ok, buf = cv2.imencode(".jp2", np.zeros((128, 128, 3), np.uint8))
    (tmp_path / "s.jp2").write_bytes(buf.tobytes())
    assert type(port_wsireader.WSIReader.open(tmp_path / "s.jp2")).__name__ == "JP2WSIReader"
    assert type(jax_wsireader.WSIReader.open(tmp_path / "s.jp2")).__name__ == "JP2WSIReader"
    from tiatoolbox_tpu_torch.annotation.geometry import Polygon
    from tiatoolbox_tpu_torch.annotation.storage import Annotation, SQLiteStore

    store = SQLiteStore(tmp_path / "s.db")
    store.append(Annotation(Polygon([(0, 0), (40, 0), (40, 30)]), {"type": 1}))
    store.close()
    assert type(port_wsireader.WSIReader.open(tmp_path / "s.db")).__name__ == "AnnotationStoreReader"
    assert type(jax_wsireader.WSIReader.open(tmp_path / "s.db")).__name__ == "AnnotationStoreReader"
    shutil.rmtree(tmp_path / "empty_dir")


def test_post_proc_resolution() -> None:
    img = np.zeros((8, 8, 3), np.uint8)
    reader = port_wsireader.WSIReader.open(img)
    from tiatoolbox_tpu_torch.utils.postproc_defs import MultichannelToRGB

    assert isinstance(reader.post_proc, MultichannelToRGB)
    assert port_wsireader.WSIReader.open(img, post_proc=None).post_proc is None
    assert isinstance(port_wsireader.VirtualWSIReader(img, post_proc="MultichannelToRGB").post_proc, MultichannelToRGB)
    with pytest.raises(ValueError, match="Invalid post_proc"):
        port_wsireader.VirtualWSIReader(img, post_proc="nope")
    np.testing.assert_array_equal(reader.read_region((0, 0), 0, (4, 4)), img[:4, :4])
