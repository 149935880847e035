"""JPEG 2000 inside other containers, read by the port and by the JAX package.

Aperio TIFF tiles (compression 33005, and 33003 whose tiles carry YCbCr
components without a colour transform: cv2, so JAX, gives the components
as they are, and so does the port), DICOM frames (transfer syntaxes
``1.2.840.10008.1.2.4.90``, lossless, and ``.91``, here 9/7), and flat
``.jp2`` / ``.j2k`` images through ``imread`` and ``imdecode``. The tests
write the files themselves: the TIFF with the port's writer, its tiles
coded by ``native.encode_j2k`` and its Compression tag set afterwards; the
DICOM with ``make_synthetic_dicom``'s encapsulated-frame path, its frames
coded by ``native.encode_j2k`` and its transfer syntax set afterwards. No
writer of the port's public API takes these options.
"""

from __future__ import annotations

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.utils.misc import imread as jax_imread
from tiatoolbox_tpu.wsicore import wsireader as jax_wsireader
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.data import synth as port_synth
from tiatoolbox_tpu_torch.utils.exceptions import FileNotSupportedError
from tiatoolbox_tpu_torch.utils.imagecodec import imdecode
from tiatoolbox_tpu_torch.utils.misc import imread
from tiatoolbox_tpu_torch.wsicore import tiffio
from tiatoolbox_tpu_torch.wsicore import wsireader as port_wsireader

READS = [(0, "level"), (1, "level"), (0.5, "mpp"), (1.0, "mpp")]


def _reads_equal(jax_reader, port_reader, reads=READS) -> None:
    w, h = port_reader.info.slide_dimensions
    for resolution, units in reads:
        for loc, size in (((0, 0), (w, h)), ((w // 3 + 5, h // 4 + 3), (97, 61)), ((w - 40, h - 30), (64, 48))):
            want = jax_reader.read_rect(loc, size, resolution=resolution, units=units)
            got = port_reader.read_rect(loc, size, resolution=resolution, units=units)
            np.testing.assert_array_equal(got, want, err_msg=f"read_rect {loc} {size} {resolution} {units}")


def _j2k_tiff(path: Path, levels: list[np.ndarray], compression: int, **encode) -> Path:
    class Writer(tiffio.TiffPyramidWriter):
        def _encode_tile(self, tile: np.ndarray) -> bytes:
            return native.encode_j2k(tile, **encode)

    Writer(path, tile_size=128, mpp=(0.5, 0.5), compression="deflate").write(levels)
    data = bytearray(path.read_bytes())
    entry = struct.pack("<HHI", 259, 3, 1)
    at = data.find(entry)
    while at >= 0:
        struct.pack_into("<H", data, at + 8, compression)
        at = data.find(entry, at + 12)
    path.write_bytes(bytes(data))
    return path


@pytest.fixture(scope="module")
def levels():
    img = synthetic_he_patch((700, 500), seed=3)
    return [img, cv2.resize(img, (350, 250), interpolation=cv2.INTER_AREA)]


@pytest.mark.parametrize(
    ("compression", "encode"),
    [(33005, {}), (33005, {"irreversible": True}), (33003, {"mct": False})],
    ids=["33005", "33005_97", "33003_no_mct"],
)
def test_aperio_j2k_tiff_is_jaxs(tmp_path, levels, compression, encode) -> None:
    path = _j2k_tiff(tmp_path / "j.tif", levels, compression, **encode)
    port_reader = port_wsireader.WSIReader.open(path)
    assert isinstance(port_reader, port_wsireader.TIFFWSIReader)
    _reads_equal(jax_wsireader.WSIReader.open(path), port_reader)
    if not encode:  # lossless: the source
        np.testing.assert_array_equal(port_reader.read_rect((0, 0), (700, 500)), levels[0])


def test_aperio_j2k_tiles_one_at_a_time_and_batched(tmp_path, levels) -> None:
    path = _j2k_tiff(tmp_path / "j.tif", levels, 33005)
    tiffio.reset_decode_counts()
    batched = tiffio.TiffFile(path).read_region(0, (0, 0), (700, 500))
    assert tiffio.decode_counts["batch"] == 24 and tiffio.decode_counts["single"] == 0
    single_file = tiffio.TiffFile(path)
    page = single_file.pages[0]
    tiles = [single_file._decode_block(page, i, (128, 128)) for i in range(len(page.offsets))]
    assert tiffio.decode_counts["single"] == 24
    across = page.tiles_across
    for i, tile in enumerate(tiles):
        y, x = (i // across) * 128, (i % across) * 128
        np.testing.assert_array_equal(tile[: 500 - y, : 700 - x][:128, :128], batched[y : y + 128, x : x + 128])
    prefetch = tiffio.TiffFile(path)
    prefetch.prefetch_regions(0, [(0, 0, 300, 200)])
    assert tiffio.decode_counts["batch"] == 24 + 6
    np.testing.assert_array_equal(prefetch.read_region(0, (0, 0), (300, 200)), batched[:200, :300])


def test_corrupt_j2k_tile_raises_naming_the_block(tmp_path, levels) -> None:
    path = _j2k_tiff(tmp_path / "j.tif", levels, 33005)
    tiff = tiffio.TiffFile(path)
    page = tiff.pages[0]
    data = bytearray(path.read_bytes())
    at = page.offsets[3]
    data[at : at + 4] = b"\x00\x00\x00\x00"  # tile 3 no longer starts with SOC
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="block 3"):
        tiffio.TiffFile(path).read_region(0, (0, 0), (700, 500))
    with pytest.raises(ValueError, match="block 3"):
        tiffio.TiffFile(path)._decode_block(page, 3, (128, 128))


def _j2k_dicom(path: Path, image: np.ndarray, syntax: bytes, **encode) -> Path:
    """A DICOM instance whose frames are JPEG 2000 codestreams."""
    original = port_synth.native.encode_jpeg
    port_synth.native.encode_jpeg = lambda tile, quality: native.encode_j2k(tile, **encode)
    try:
        port_synth.make_synthetic_dicom(path, image=image, frame_size=128, compression="jpeg")
    finally:
        port_synth.native.encode_jpeg = original
    path.write_bytes(path.read_bytes().replace(b"1.2.840.10008.1.2.4.50", syntax, 1))
    return path


@pytest.mark.parametrize(
    ("syntax", "encode"),
    [(b"1.2.840.10008.1.2.4.90", {}), (b"1.2.840.10008.1.2.4.91", {"irreversible": True, "layers": 2})],
    ids=["90", "91"],
)
def test_dicom_j2k_frames_are_jaxs(tmp_path, syntax, encode) -> None:
    img = synthetic_he_patch((333, 250), seed=8)
    folder = tmp_path / "pyr"
    folder.mkdir()
    _j2k_dicom(folder / "l0.dcm", img, syntax, **encode)
    half = cv2.resize(img, (166, 125), interpolation=cv2.INTER_AREA)
    _j2k_dicom(folder / "l1.dcm", half, syntax, **encode)
    port_reader = port_wsireader.DICOMWSIReader(folder)
    _reads_equal(jax_wsireader.DICOMWSIReader(folder), port_reader)
    if not encode:
        np.testing.assert_array_equal(port_reader.read_rect((0, 0), (333, 250)), img)
    part = port_wsireader.WSIReader.open(folder / "l0.dcm").slide.levels[0].parts[0]
    np.testing.assert_array_equal(part.decode_frame(2), part.decode_frames([0, 2])[1])


def test_dicom_refuses_htj2k(tmp_path) -> None:
    img = synthetic_he_patch((128, 128), seed=3)
    path = _j2k_dicom(tmp_path / "h.dcm", img, b"1.2.840.10008.1.2.4.50")
    # the longer UID: the element's length grows to 24 (the port reads the
    # file meta element by element)
    old = b"UI" + struct.pack("<H", 22) + b"1.2.840.10008.1.2.4.50"
    path.write_bytes(path.read_bytes().replace(old, b"UI" + struct.pack("<H", 24) + b"1.2.840.10008.1.2.4.201\x00", 1))
    with pytest.raises(FileNotSupportedError, match="HTJ2K"):
        port_wsireader.WSIReader.open(path).read_rect((0, 0), (64, 64))


@pytest.mark.parametrize("kind", ["rgb_jp2", "grey_jp2", "raw_j2k"])
def test_imread_jpeg2000_is_jaxs(tmp_path, kind) -> None:
    img = synthetic_he_patch((203, 151), seed=11)
    if kind == "raw_j2k":
        path = tmp_path / "image.j2k"
        path.write_bytes(native.encode_j2k(img))
    else:
        path = tmp_path / f"{kind}.jp2"
        cv2.imwrite(str(path), img[..., 0] if kind == "grey_jp2" else img[..., ::-1])
    want = jax_imread(path)
    got = imread(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    data = path.read_bytes()
    colour = imdecode(data, "color")
    assert colour.shape == (151, 203, 3)
    np.testing.assert_array_equal(colour, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])


def test_imdecode_jpeg2000_corrupt_and_refused() -> None:
    stream = native.encode_j2k(synthetic_he_patch((64, 64), seed=1))
    assert imdecode(stream[: len(stream) // 2]) is None  # corrupt: None, as cv2 gives where it fails
    cod = stream.index(b"\xff\x52") + 4
    ht = stream[: cod + 8] + b"\x40" + stream[cod + 9 :]
    with pytest.raises(FileNotSupportedError, match="HTJ2K"):
        imdecode(ht)
