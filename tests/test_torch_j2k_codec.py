"""The port's JPEG 2000 codec (``csrc/j2kdec.cpp``, ``csrc/j2kenc.cpp``) against OpenCV.

OpenCV's bundled OpenJPEG (``cv2.imdecode``, BGR turned to RGB) is the
reference: the JAX package decodes every JPEG 2000 stream through it.

- Streams cv2 writes (lossless, its lossy default and lower rates, grey,
  odd sizes) decode bit for bit.
- The port encoder's option matrix (every code-block style flag, every
  progression order with precincts and layers, SOP/EPH, tile-parts, no
  colour transform, the irreversible 9/7 path) is decoded by cv2 and by the
  port, and the two agree bit for bit: the stated tolerance of the 9/7 path
  is 0 levels, as the decoder lifts in OpenJPEG's float operations and
  order. Reversible streams also give the source back.
- ``shrink_linear_exact`` is ``cv2.resize(INTER_LINEAR_EXACT)`` at 2, 4 and
  8 on odd sizes, and with the decode it gives ``IMREAD_REDUCED_*``.
- Truncated and corrupt streams raise ``J2kDecodeError``, and so does every
  refused feature, naming it (as ``tests/test_fuzz_codecs.py:202-230``
  feeds the JAX package's parser).
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.utils.transforms import shrink_linear_exact

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_j2k_golden as golden  # noqa: E402

X1000 = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
CV2_MODES = {"lossless": (X1000, 1000), "default": (), "x200": (X1000, 200), "x50": (X1000, 50)}
CV2_SIZES = [(32, 32), (33, 47), (47, 33), (65, 97), (128, 129), (203, 301)]


def _cv2(stream: bytes) -> np.ndarray:
    return golden.cv2_pixels(stream)


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("mode", list(CV2_MODES))
@pytest.mark.parametrize("size", CV2_SIZES, ids=[f"{h}x{w}" for h, w in CV2_SIZES])
def test_cv2_streams_decode_bit_for_bit(size, mode, grey) -> None:
    h, w = size
    image = golden.sample_image(h, w, seed=h * w, channels=1 if grey else 3)
    stream = golden.cv2_stream(image, CV2_MODES[mode])
    got = native.decode_j2k(stream)
    np.testing.assert_array_equal(got, _cv2(stream))
    if mode == "lossless":
        np.testing.assert_array_equal(got, image.reshape(h, w, -1))


# the golden set's encoder cases and more: tiles with ragged edges, levels
# past the tile's size, 9/7 in each progression order
MATRIX = {
    **golden.ENCODER_CASES,
    "ragged_tiles_levels_6": {"tile_size": (40, 24), "levels": 6},
    "no_levels": {"levels": 0},
    "grey_termall_layers": {"grey": True, "cblk_style": ("termall",), "layers": 4},
    "97_no_mct": {"irreversible": True, "mct": False},
    "97_tiles_precincts": {"irreversible": True, "tile_size": 32, "precincts": [(5, 5), (5, 5), (4, 4), (4, 4), (3, 4), (3, 3)]},
    **{
        f"97_{p.lower()}": {"irreversible": True, "progression": p, "layers": 3, "sop": True}
        for p in native.J2K_PROGRESSIONS
    },
}


@pytest.mark.parametrize("name", list(MATRIX))
def test_encoder_matrix_decodes_as_cv2_does(name) -> None:
    opts = dict(MATRIX[name])
    image = golden.sample_image(45, 37, seed=len(name))
    src = image[:, :, 0] if opts.pop("grey", False) else image
    stream = native.encode_j2k(src, **opts)
    got = native.decode_j2k(stream)
    np.testing.assert_array_equal(got, _cv2(stream))  # the 9/7 tolerance too: 0 levels
    if not opts.get("irreversible"):
        np.testing.assert_array_equal(got, src.reshape(45, 37, -1))
    else:
        psnr = 10 * np.log10(255.0**2 / np.mean((got.astype(float) - src.reshape(45, 37, -1)) ** 2))
        assert psnr > 30


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (7, 5), (1, 40), (40, 1), (64, 64), (100, 130)])
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_lossless_round_trip(size, grey) -> None:
    rng = np.random.default_rng(sum(size))
    image = rng.integers(0, 256, (*size, 1 if grey else 3), dtype=np.uint8)
    for tile in (None, 16):
        stream = native.encode_j2k(image, tile)
        np.testing.assert_array_equal(native.decode_j2k(stream), image)
        np.testing.assert_array_equal(_cv2(stream), image)


def test_threads_tiles_and_batches_agree() -> None:
    image = golden.sample_image(150, 170, seed=3)
    stream = native.encode_j2k(image, 64, cblk_style=("bypass",), layers=2)
    whole = native.decode_j2k(stream, n_threads=1)
    np.testing.assert_array_equal(native.decode_j2k(stream, n_threads=8), whole)
    info = native.j2k_header(stream)
    assert (info["tiles_across"], info["tiles_down"], info["width"], info["height"]) == (3, 3, 170, 150)
    tiles = native.decode_j2k_tiles(stream, [8, 0, 4], n_threads=3)
    np.testing.assert_array_equal(tiles[0], whole[128:, 128:])
    np.testing.assert_array_equal(tiles[1], whole[:64, :64])
    np.testing.assert_array_equal(tiles[2], whole[64:128, 64:128])
    untiled = native.encode_j2k(image)
    batch = native.decode_j2k_batch([stream, untiled, stream], n_threads=2)
    for got in batch:
        np.testing.assert_array_equal(got, image)
    with pytest.raises(native.J2kDecodeError, match="tile index"):
        native.decode_j2k_tiles(stream, [9])
    with pytest.raises(native.J2kDecodeError, match="stream 1") as err:
        native.decode_j2k_batch([stream, untiled[:200]])
    assert err.value.index == 1


@pytest.mark.parametrize("size", [(203, 301), (33, 17), (75, 93), (64, 512)])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_shrink_is_cv2_linear_exact(size, factor) -> None:
    h, w = size
    rng = np.random.default_rng(h + w + factor)
    for image in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.integers(0, 256, (h, w), dtype=np.uint8)):
        want = cv2.resize(image, (w // factor, h // factor), interpolation=cv2.INTER_LINEAR_EXACT)
        np.testing.assert_array_equal(shrink_linear_exact(image, factor), want)


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_reduced_reads_are_the_decode_shrunk(grey) -> None:
    image = golden.sample_image(77, 101, seed=9, channels=1 if grey else 3)
    stream = golden.cv2_stream(image, ())
    full = native.decode_j2k(stream)
    flags = {
        2: (cv2.IMREAD_REDUCED_GRAYSCALE_2, cv2.IMREAD_REDUCED_COLOR_2),
        4: (cv2.IMREAD_REDUCED_GRAYSCALE_4, cv2.IMREAD_REDUCED_COLOR_4),
        8: (cv2.IMREAD_REDUCED_GRAYSCALE_8, cv2.IMREAD_REDUCED_COLOR_8),
    }
    for factor, (grey_flag, colour_flag) in flags.items():
        want = golden.cv2_pixels(stream, grey_flag if grey else colour_flag)
        np.testing.assert_array_equal(shrink_linear_exact(full, factor), want)


# -- refused features and broken streams ------------------------------------------


def _main_header_end(stream: bytes) -> int:
    at = 2
    while stream[at : at + 2] != b"\xff\x90":
        at += 2 + int.from_bytes(stream[at + 2 : at + 4], "big")
    return at


def _segment_at(stream: bytes, marker: bytes) -> int:
    at = 2
    while stream[at : at + 2] != marker:
        at += 2 + int.from_bytes(stream[at + 2 : at + 4], "big")
    return at


def _with_main_segment(stream: bytes, marker: int, body: bytes) -> bytes:
    at = _main_header_end(stream)
    return stream[:at] + marker.to_bytes(2, "big") + (len(body) + 2).to_bytes(2, "big") + body + stream[at:]


def _with_tile_segment(stream: bytes, marker: int, body: bytes) -> bytes:
    sot = _main_header_end(stream)
    seg = marker.to_bytes(2, "big") + (len(body) + 2).to_bytes(2, "big") + body
    psot = int.from_bytes(stream[sot + 6 : sot + 10], "big") + len(seg)
    return stream[: sot + 6] + psot.to_bytes(4, "big") + stream[sot + 10 : sot + 12] + seg + stream[sot + 12 :]


def _patched(stream: bytes, offset: int, value: bytes) -> bytes:
    return stream[:offset] + value + stream[offset + len(value) :]


def _refusals() -> dict[str, tuple[bytes, str]]:
    image = golden.sample_image(40, 48, seed=5)
    rgb = native.encode_j2k(image)
    grey = native.encode_j2k(image[:, :, 0])
    cod = _segment_at(rgb, b"\xff\x52") + 4  # COD body
    two = grey[:4] + (int.from_bytes(grey[4:6], "big") + 3).to_bytes(2, "big") + grey[6:40]
    two += (2).to_bytes(2, "big") + grey[42:45] + grey[42:45] + grey[45:]
    return {
        "poc": (_with_main_segment(rgb, 0xFF5F, bytes([0, 0, 0, 1, 6, 1])), "POC"),
        "ppm": (_with_main_segment(rgb, 0xFF60, b"\x00"), "PPM"),
        "ppt": (_with_tile_segment(rgb, 0xFF61, b"\x00"), "PPT"),
        "rgn": (_with_main_segment(rgb, 0xFF5E, b"\x00\x00\x02"), "RGN"),
        "cap": (_with_main_segment(rgb, 0xFF50, b"\x00\x02\x00\x00\x00\x00"), "HTJ2K"),
        "rsiz_part15": (_patched(rgb, 6, b"\x40\x00"), "HTJ2K"),
        "ht_block_style": (_patched(rgb, cod + 8, b"\x40"), "HTJ2K"),
        "sub_sampling": (_patched(rgb, 43, b"\x02"), "sub-sampling"),
        "precision_12": (_patched(rgb, 42, b"\x0b"), "precision 12 bits"),
        "signed": (_patched(rgb, 42, b"\x87"), "signed"),
        "two_components": (two, "2 components"),
        "part2_transform": (_patched(rgb, cod + 4, b"\x02"), "Part 2"),
        "part2_wavelet": (_patched(rgb, cod + 9, b"\x02"), "Part 2"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_refused_features_raise_naming_them(case) -> None:
    stream, name = _refusals()[case]
    with pytest.raises(native.J2kDecodeError, match=f"unsupported JPEG 2000 feature: .*{name}"):
        native.decode_j2k(stream)


def test_truncated_and_corrupt_streams_raise() -> None:
    image = golden.sample_image(64, 64, seed=6)
    tiled = native.encode_j2k(image, 32, layers=2)
    garbage = [
        b"",
        b"\x00" * 64,
        bytes.fromhex("ff4fff51") + b"\x00" * 16,  # SOC+SIZ cut short
        bytes.fromhex("0000000c6a5020200d0a870a") + b"\x01" * 8,  # jp2 signature, no jp2c
        bytes.fromhex("ff4fff51002f") + b"\xff" * 64,  # bogus SIZ body (its Rsiz reads as Part 15)
    ]
    for data in garbage:
        with pytest.raises(native.J2kDecodeError):
            native.decode_j2k(data)
    candidates = [
        *(tiled[: int(len(tiled) * f)] for f in (0.1, 0.4, 0.8, 0.99)),
        _patched(tiled, _segment_at(tiled, b"\xff\x52") + 5, b"\x21"),  # 33 levels
        _patched(tiled, _main_header_end(tiled), b"\xff\x91"),  # no SOT after the header
    ]
    for data in candidates:
        with pytest.raises(native.J2kDecodeError, match="corrupt|truncated"):
            native.decode_j2k(data)
    # flipped body bytes either decode or raise; nothing else
    rng = np.random.default_rng(7)
    for _ in range(50):
        data = bytearray(tiled)
        at = int(rng.integers(_main_header_end(tiled), len(tiled)))
        data[at] ^= int(rng.integers(1, 256))
        try:
            native.decode_j2k(bytes(data))
        except native.J2kDecodeError:
            pass


def test_encode_rejects_bad_options() -> None:
    image = np.zeros((16, 16, 3), np.uint8)
    for kwargs in ({"progression": "XYZ"}, {"cblk_style": ("fast",)}, {"code_block": (48, 64)},
                   {"precincts": [(4, 4)]}, {"levels": 40}):
        with pytest.raises(ValueError):
            native.encode_j2k(image, **kwargs)
    with pytest.raises(ValueError, match="RGB or"):
        native.encode_j2k(np.zeros((4, 4, 2), np.uint8))


def test_golden_file_is_what_the_script_writes() -> None:
    committed = np.load(golden.DEFAULT_OUT)
    fresh = golden.build()
    assert sorted(committed.files) == sorted(fresh)
    for key, value in fresh.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert golden.DEFAULT_OUT.stat().st_size < 160_000
