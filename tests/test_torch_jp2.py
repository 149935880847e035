"""Tiled JP2 reads of the port (``wsicore/jp2.py``, ``JP2WSIReader``) against the JAX package.

The cases of JAX's ``tests/test_jp2.py``, each run on the same bytes
through both packages: JAX decodes with cv2 (tile extraction
transcoding), the port with its own decoder in place. Grid, tile bounds
and ``extract_tile_codestream`` bytes; ``decode_tile`` and ``read_region``
at reduce 1, 2, 4 and 8 across tile borders and over the ragged last tile
(whose zero edge the port keeps); ``JP2WSIReader``'s ``read_rect``,
``read_bounds`` and thumbnail at every level, tiled and untiled, colour and
grey; the ``resc`` mpp; ``WSIReader.open`` dispatch. The port's writer is
lossless where JAX's is cv2's lossy default.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu.data.synth import synthetic_he_patch
from tiatoolbox_tpu.wsicore import jp2 as jax_jp2
from tiatoolbox_tpu.wsicore import wsireader as jax_wsireader
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.utils.exceptions import FileNotSupportedError
from tiatoolbox_tpu_torch.wsicore import wsireader as port_wsireader
from tiatoolbox_tpu_torch.wsicore.jp2 import J2KCodestream, encode_tiled_j2k, jp2_container, write_tiled_jp2
from tiatoolbox_tpu_torch.wsicore.wsireader import JP2WSIReader, WSIReader

WINDOWS = [
    ((0, 0), (256, 256)),  # one tile
    ((100, 60), (400, 300)),  # across four tiles
    ((900, 640), (101, 61)),  # over the ragged last tiles
    ((250, 250), (20, 20)),  # a tiny window across a seam
    ((0, 0), (1001, 701)),  # everything
    ((3, 5), (998, 690)),  # odd origin, edge to edge
]


def _rgb(bgr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(bgr[..., ::-1]) if bgr.ndim == 3 else bgr


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    """JAX's tiled JP2 (cv2 tiles stitched, lossy) of a 1001x701 image: its
    last tiles are 233 and 189 pixels, so reduced reads floor them."""
    img = synthetic_he_patch((1001, 701), seed=7)
    path = tmp_path_factory.mktemp("jp2") / "tiled.jp2"
    jax_jp2.write_tiled_jp2(path, img, tile_size=256)
    data = path.read_bytes()
    whole = _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return {"path": path, "img": img, "data": data, "whole": whole}


class TestCodestream:
    def test_parse_grid(self, tiled) -> None:
        cs = J2KCodestream.from_bytes(tiled["data"])
        ref = jax_jp2.J2KCodestream.from_bytes(tiled["data"])
        assert cs.image_size == ref.image_size == (1001, 701)
        assert cs.grid_shape == ref.grid_shape == (4, 3)
        assert sorted(cs.tiles) == list(range(12))
        assert cs.decomposition_levels == ref.decomposition_levels

    def test_tile_bounds_clip_to_image(self) -> None:
        img = synthetic_he_patch((600, 300), seed=1)
        data = jax_jp2.encode_tiled_j2k(img, tile_size=256)
        cs, ref = J2KCodestream.from_bytes(data), jax_jp2.J2KCodestream.from_bytes(data)
        assert cs.tile_bounds(2) == ref.tile_bounds(2) == (512, 0, 600, 256)  # edge tile clipped
        assert [cs.tile_bounds(i) for i in range(6)] == [ref.tile_bounds(i) for i in range(6)]

    def test_extract_tile_codestream_bytes_are_jaxs(self, tiled) -> None:
        cs, ref = J2KCodestream.from_bytes(tiled["data"]), jax_jp2.J2KCodestream.from_bytes(tiled["data"])
        for index in range(12):
            assert cs.extract_tile_codestream(index) == ref.extract_tile_codestream(index)

    @pytest.mark.parametrize("reduce", [1, 2, 4, 8])
    def test_decode_tile_is_jaxs(self, tiled, reduce) -> None:
        cs, ref = J2KCodestream.from_bytes(tiled["data"]), jax_jp2.J2KCodestream.from_bytes(tiled["data"])
        for index in (0, 5, 3, 11):  # interior, ragged right, ragged bottom-right
            np.testing.assert_array_equal(cs.decode_tile(index, reduce), ref.decode_tile(index, reduce))

    @pytest.mark.parametrize("reduce", [1, 2, 4, 8])
    def test_window_is_jaxs(self, tiled, reduce) -> None:
        cs, ref = J2KCodestream.from_bytes(tiled["data"]), jax_jp2.J2KCodestream.from_bytes(tiled["data"])
        for loc, size in WINDOWS:
            got = cs.read_region(loc, size, reduce=reduce)
            np.testing.assert_array_equal(got, ref.read_region(loc, size, reduce=reduce), err_msg=f"{loc} {size}")
            if reduce == 1:
                want = tiled["whole"][loc[1] : loc[1] + size[1], loc[0] : loc[0] + size[0]]
                np.testing.assert_array_equal(got, want)

    def test_ragged_zero_edge(self, tiled) -> None:
        """JAX floors each reduced tile and sizes the window with a ceiling:
        the last row and column of a whole reduced read stay 0."""
        region = J2KCodestream.from_bytes(tiled["data"]).read_region((0, 0), (1001, 701), reduce=2)
        assert region.shape == (351, 501, 3)
        assert not region[-1].any() and not region[:, -1].any()
        assert region[-2].any() and region[:, -2].any()

    def test_reduced_window(self, tiled) -> None:
        cs = J2KCodestream.from_bytes(tiled["data"])
        assert cs.read_region((0, 0), (512, 512), reduce=4).shape == (128, 128, 3)

    def test_windowed_read_decodes_only_needed_tiles(self, tiled, monkeypatch) -> None:
        cs = J2KCodestream.from_bytes(tiled["data"])
        decoded = []
        orig = J2KCodestream._decode_tiles_uncached

        def spy(self, indices, reduce):
            decoded.extend(indices)
            return orig(self, indices, reduce)

        monkeypatch.setattr(J2KCodestream, "_decode_tiles_uncached", spy)
        cs.read_region((10, 10), (100, 100))
        assert decoded == [0]  # one tile, not twelve
        cs.read_region((200, 200), (100, 100))
        assert decoded == [0, 1, 4, 5]  # tile 0 from the cache

    def test_misaligned_origin_raises(self) -> None:
        img = synthetic_he_patch((256, 256), seed=2)
        cs = J2KCodestream.from_bytes(jax_jp2.encode_tiled_j2k(img, tile_size=128))
        cs.xtsiz = cs.ytsiz = 40  # a grid not aligned to 2^levels
        with pytest.raises((ValueError, KeyError)):
            cs.extract_tile_codestream(1)

    def test_single_tile_encode_roundtrip(self) -> None:
        """The port's writer is lossless: both decoders give the source back."""
        img = synthetic_he_patch((320, 256), seed=3)
        data = encode_tiled_j2k(img, tile_size=256)
        np.testing.assert_array_equal(_rgb(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)), img)
        np.testing.assert_array_equal(native.decode_j2k(data), img)
        cs, ref = J2KCodestream.from_bytes(data), jax_jp2.J2KCodestream.from_bytes(data)
        assert cs.grid_shape == ref.grid_shape == (2, 1)
        for reduce in (1, 2, 4):
            np.testing.assert_array_equal(cs.read_region((5, 7), (300, 240), reduce), ref.read_region((5, 7), (300, 240), reduce))

    def test_tile_size_must_align_and_quality_is_not_ported(self) -> None:
        with pytest.raises(ValueError, match="64"):
            encode_tiled_j2k(np.zeros((128, 128, 3), np.uint8), tile_size=100)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            encode_tiled_j2k(np.zeros((128, 128, 3), np.uint8), quality=200)


# integer scale factors only: at others the packages' area resizes may part
# by a level (ROADMAP.md section 3)
READS = [(0, "level"), (1, "level"), (0.5, "baseline"), (1.0, "mpp")]


def _reads_equal(jax_reader, port_reader) -> None:
    assert port_reader.info.level_dimensions == jax_reader.info.level_dimensions
    assert port_reader.info.level_downsamples == jax_reader.info.level_downsamples
    w, h = port_reader.info.slide_dimensions
    for resolution, units in READS:
        for loc, size in (((0, 0), (w, h)), ((w // 3 + 5, h // 4 + 3), (97, 61)), ((w - 40, h - 30), (64, 48))):
            want = jax_reader.read_rect(loc, size, resolution=resolution, units=units)
            got = port_reader.read_rect(loc, size, resolution=resolution, units=units)
            np.testing.assert_array_equal(got, want, err_msg=f"read_rect {loc} {size} {resolution} {units}")
        bounds = (w // 5, h // 6, w // 5 + 120, h // 6 + 90)
        want = jax_reader.read_bounds(bounds, resolution=resolution, units=units)
        np.testing.assert_array_equal(port_reader.read_bounds(bounds, resolution=resolution, units=units), want)
    np.testing.assert_array_equal(port_reader.slide_thumbnail(1, "level"), jax_reader.slide_thumbnail(1, "level"))


class TestReaderIntegration:
    def test_open_dispatches_to_jp2(self, tiled) -> None:
        reader = WSIReader.open(tiled["path"])
        assert isinstance(reader, JP2WSIReader)
        assert reader.info.slide_dimensions == (1001, 701)
        raw = tiled["path"].with_suffix(".j2k")  # by its magic bytes
        raw.write_bytes(tiled["data"])
        assert isinstance(WSIReader.open(raw), JP2WSIReader)

    def test_read_rect_uses_windowed_path(self, tiled, monkeypatch) -> None:
        reader = WSIReader.open(tiled["path"])
        assert reader._codestream is not None
        monkeypatch.setattr(
            JP2WSIReader, "_decode_plane", lambda self, scale: pytest.fail("full-image decode of a tiled jp2")
        )
        region = reader.read_rect((300, 200), (224, 224), resolution=0, units="level")
        np.testing.assert_array_equal(region, tiled["whole"][200:424, 300:524])

    def test_tiled_reads_are_jaxs(self, tiled) -> None:
        _reads_equal(
            jax_wsireader.WSIReader.open(tiled["path"], mpp=(0.5, 0.5), power=20),
            WSIReader.open(tiled["path"], mpp=(0.5, 0.5), power=20),
        )

    def test_thumbnail_from_tiles(self, tiled) -> None:
        reader = WSIReader.open(tiled["path"])
        thumb = reader.slide_thumbnail(resolution=1, units="level")
        assert thumb.ndim == 3 and thumb.shape[2] == 3
        np.testing.assert_array_equal(thumb, jax_wsireader.WSIReader.open(tiled["path"]).slide_thumbnail(1, "level"))

    def test_read_bounds_matches_whole(self, tiled) -> None:
        region = WSIReader.open(tiled["path"]).read_bounds((256, 256, 512, 512), resolution=0, units="level")
        np.testing.assert_array_equal(region, tiled["whole"][256:512, 256:512])

    @pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
    def test_untiled_jp2_reads_are_jaxs(self, tmp_path, grey) -> None:
        """Single-tile files take the reduced-plane path in both packages."""
        img = synthetic_he_patch((700, 600), seed=4)
        path = tmp_path / "plain.jp2"
        cv2.imwrite(str(path), img[..., 0] if grey else img[..., ::-1])
        reader = WSIReader.open(path)
        assert reader._codestream is None  # single tile: the plane path
        _reads_equal(jax_wsireader.WSIReader.open(path, mpp=(0.5, 0.5), power=20), WSIReader.open(path, mpp=(0.5, 0.5), power=20))
        assert reader.read_rect((50, 50), (64, 64), resolution=0, units="level").shape == (64, 64, 1 if grey else 3)

    def test_port_written_slide_with_mpp(self, tmp_path) -> None:
        img = synthetic_he_patch((1100, 900), seed=6)
        path = tmp_path / "port.jp2"
        path.write_bytes(jp2_container(encode_tiled_j2k(img, 128), mpp=(0.25, 0.5)))
        jax_reader, port_reader = jax_wsireader.WSIReader.open(path), WSIReader.open(path)
        np.testing.assert_array_equal(port_reader.info.mpp, (0.25, 0.5))
        np.testing.assert_array_equal(port_reader.info.mpp, jax_reader.info.mpp)
        assert port_reader.info.objective_power == jax_reader.info.objective_power
        np.testing.assert_array_equal(port_reader.read_rect((0, 0), (1100, 900)), img)
        _reads_equal(jax_reader, port_reader)
        raw = tmp_path / "raw.jp2"
        write_tiled_jp2(raw, img, tile_size=128)
        assert port_wsireader.WSIReader.open(raw).info.mpp is None

    def test_unreadable_file_raises(self, tmp_path) -> None:
        path = tmp_path / "bad.jp2"
        path.write_bytes(b"\x00" * 100)
        with pytest.raises(FileNotSupportedError, match="JP2"):
            WSIReader.open(path)
