"""The port's baseline JPEG codec against OpenCV and the JAX package's decoder.

Streams come from ``cv2.imencode`` (OpenCV's bundled libjpeg-turbo) on
seeded images. The port's decoder (``csrc/jpegdec.cpp``) must give the
pixels of ``cv2.imdecode`` (BGR turned to RGB) and of the JAX package's
native batch decoder (``tiatoolbox_tpu.native.decode_jpeg_batch``, the
system libjpeg) bit for bit over qualities, sampling factors, sizes, grey
frames, restart intervals, optimised Huffman tables, different luma and
chroma quality, abbreviated streams with split-off tables, RGB-coded
streams and a stream cut short. The encoder (``csrc/jpegenc.cpp``) is held
to ``cv2.imencode``'s bytes, which is stronger than the required pixels of
the decoded stream; so both are checked. Streams the port does not decode
(progressive, multi-scan, arithmetic, 12-bit, lossless, cut without a
marker) must raise.
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu import native as jax_native
from tiatoolbox_tpu.wsicore.tiffio import _merge_jpeg_tables as jax_merge
from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch
from tiatoolbox_tpu_torch.wsicore.tiffio import _merge_jpeg_tables

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))

import make_jpeg_golden as golden  # noqa: E402
import chip_smoke  # noqa: E402
from chip_smoke import JPEG_PSNR_FLOOR_DB  # noqa: E402

SAMPLINGS = golden.SAMPLINGS
SIZES = [(1, 1), (7, 13), (17, 33), (240, 240), (256, 256)]
QUALITIES = [50, 75, 90, 95, 100]


def _image(h: int, w: int, seed: int) -> np.ndarray:
    return golden.sample_image(h, w, seed)


def _cv2_encode(img: np.ndarray, *params: int) -> bytes:
    bgr = img if img.ndim == 2 else img[:, :, ::-1]
    ok, buf = cv2.imencode(".jpg", bgr, list(params))
    assert ok
    return buf.tobytes()


def _cv2_decode(stream: bytes) -> np.ndarray | None:
    img = cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    return img[:, :, None] if img.ndim == 2 else np.ascontiguousarray(img[:, :, ::-1])


def _assert_same_as_references(stream: bytes) -> np.ndarray:
    """The port's pixels equal cv2's and the JAX batch decoder's."""
    got = native.decode_jpeg(stream)
    want = _cv2_decode(stream)
    assert want is not None
    np.testing.assert_array_equal(got, want)
    h, w, c = got.shape
    jax = jax_native.decode_jpeg_batch([stream], h, w, out_ch=c)
    assert jax is not None
    np.testing.assert_array_equal(got, jax[0])
    return got


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLINGS), ids=str)
@pytest.mark.parametrize("quality", QUALITIES)
def test_decoder_matrix(quality: int, sampling: str, size) -> None:
    img = _image(*size, seed=quality + size[0])
    stream = _cv2_encode(
        img, cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]
    )
    _assert_same_as_references(stream)


@pytest.mark.parametrize("quality", [50, 90, 100])
def test_decoder_grey(quality: int) -> None:
    stream = _cv2_encode(golden.sample_image(37, 70, 5, channels=1), cv2.IMWRITE_JPEG_QUALITY, quality)
    got = _assert_same_as_references(stream)
    assert got.shape == (37, 70, 1)
    # out_ch 3 replicates grey, as libjpeg's grey-to-RGB conversion does
    rgb = native.decode_jpeg_batch([stream], 37, 70, out_ch=3)[0]
    np.testing.assert_array_equal(rgb, np.repeat(got, 3, axis=2))


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_decoder_restart_interval(interval: int) -> None:
    img = _image(70, 90, 6)
    stream = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, interval)
    assert b"\xff\xd0" in stream
    _assert_same_as_references(stream)


def test_decoder_optimised_tables() -> None:
    img = _image(64, 80, 7)
    stream = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    assert stream != _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    _assert_same_as_references(stream)


def test_decoder_luma_chroma_quality() -> None:
    img = _image(48, 64, 8)
    stream = _cv2_encode(
        img, cv2.IMWRITE_JPEG_LUMA_QUALITY, 90, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 40
    )
    _assert_same_as_references(stream)


@pytest.mark.parametrize(
    "variant", ["rgb_ids", "adobe_rgb", "dqt16", "no_dht", "fill_ff", "cut_eoi", "abbreviated"]
)
def test_decoder_edited_streams(variant: str) -> None:
    """RGB coding by ids and by an Adobe marker, 16-bit tables, the standard
    Huffman tables where none are given, fill bytes, a stream cut short and
    closed by EOI (zero bits, then grey MCUs), and split-off tables merged
    back as both readers merge a TIFF's JPEGTables."""
    base = _cv2_encode(_image(40, 56, 9), cv2.IMWRITE_JPEG_QUALITY, 90)
    edited = golden.edited_streams(base)
    if variant == "abbreviated":
        stream = _merge_jpeg_tables(edited["tables"], edited["tile"])
        assert stream == jax_merge(edited["tables"], edited["tile"])
        assert native.decode_jpeg(stream).shape == (40, 56, 3)
    else:
        stream = edited[variant]
    got = _assert_same_as_references(stream)
    if variant in ("rgb_ids", "adobe_rgb"):
        # the same entropy data read as RGB, not as YCbCr
        assert not np.array_equal(got, native.decode_jpeg(base))


def test_decoder_stream_cut_without_marker_raises() -> None:
    """cv2 returns no image where its decode runs out of data before a
    marker (its memory source cannot be refilled), and JAX's per-tile path
    raises there; the port raises too. (JAX's batch decoder pads such a
    stream with a fake EOI and returns pixels.)"""
    stream = _cv2_encode(_image(64, 64, 10), cv2.IMWRITE_JPEG_QUALITY, 90)
    for cut in (len(stream) // 3, len(stream) // 2, len(stream) - 2):
        assert _cv2_decode(stream[:cut]) is None
        with pytest.raises(ValueError, match="truncated"):
            native.decode_jpeg(stream[:cut])


def _frame_edit(stream: bytes, offset: int, value: int) -> bytes:
    """``stream`` with byte ``offset`` of its SOF0 segment set to ``value``."""
    sof = stream.index(b"\xff\xc0")
    out = bytearray(stream)
    out[sof + offset] = value
    return bytes(out)


@pytest.mark.parametrize(
    ("name", "match"),
    [
        ("progressive", "progressive"),
        ("multi_scan", "several scans"),
        ("arithmetic", "arithmetic"),
        ("precision12", "8-bit"),
        ("lossless", "lossless"),
        ("not_jpeg", "SOI"),
    ],
)
def test_decoder_refuses_unsupported_codings(name: str, match: str) -> None:
    img = _image(32, 32, 11)
    base = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    if name == "progressive":
        stream = _cv2_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        assert b"\xff\xc2" in stream
    elif name == "multi_scan":
        # a frame of 3 components whose first scan holds one of them
        sos = base.index(b"\xff\xda")
        stream = base[:sos] + b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00" + base[sos + 14 :]
    elif name == "arithmetic":
        stream = _frame_edit(base, 1, 0xC9)
    elif name == "precision12":
        stream = _frame_edit(base, 4, 12)
    elif name == "lossless":
        stream = _frame_edit(base, 1, 0xC3)
    else:
        stream = b"\x00" + base[1:]
    with pytest.raises(ValueError, match=match):
        native.decode_jpeg(stream)
    with pytest.raises(native.JpegDecodeError, match=match) as info:
        native.decode_jpeg_batch([base, stream], 32, 32)
    assert info.value.index == 1


def test_batch_threads_agree_and_crop_pad() -> None:
    """1 thread and 8 threads give the same batch; each stream lands in the
    top-left of a zeroed tile, cropped where it is larger."""
    rng = np.random.default_rng(12)
    streams, images = [], []
    for k in range(24):
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        img = _image(h, w, 100 + k)
        images.append(img)
        streams.append(_cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(50, 101))))
    one = native.decode_jpeg_batch(streams, 64, 64, n_threads=1)
    many = native.decode_jpeg_batch(streams, 64, 64, n_threads=8)
    np.testing.assert_array_equal(one, many)
    for tile, stream, img in zip(one, streams, images):
        h, w = min(img.shape[0], 64), min(img.shape[1], 64)
        np.testing.assert_array_equal(tile[:h, :w], _cv2_decode(stream)[:h, :w])
        assert not tile[h:].any() and not tile[:, w:].any()
    jax = jax_native.decode_jpeg_batch(streams, 64, 64, out_ch=3, n_threads=4)
    np.testing.assert_array_equal(one, jax)


ENCODE_SIZES = [(1, 1), (2, 31), (7, 13), (17, 33), (64, 64), (100, 37), (240, 256)]


@pytest.mark.parametrize("size", ENCODE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [1, 25, 50, 75, 90, 95, 100])
@pytest.mark.parametrize("channels", [3, 1])
def test_encoder_bytes_match_cv2(size, quality: int, channels: int) -> None:
    """The encoder's stream is byte for byte cv2's (so cv2 also decodes it
    to cv2's own stream's pixels, which is checked as well)."""
    img = golden.sample_image(*size, seed=quality + 7 * size[1], channels=channels)
    ours = native.encode_jpeg(img, quality)
    want = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality)
    np.testing.assert_array_equal(_cv2_decode(ours), _cv2_decode(want))
    assert ours == want


def test_encoder_on_he_patch_and_psnr_floor() -> None:
    img = synthetic_he_patch((512, 384), seed=13)
    ours = native.encode_jpeg(img, 90)
    assert ours == _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    back = native.decode_jpeg(ours).astype(np.float64)
    mse = float(np.mean((back - img) ** 2))
    psnr = 10 * np.log10(255.0**2 / mse)
    # chip_smoke.py holds the card's build to the floor on a 2048x1536 patch
    assert psnr >= JPEG_PSNR_FLOOR_DB + 1.0, psnr


def test_reciprocal_quantiser_matches_division() -> None:
    """libjpeg-turbo quantises by a reciprocal multiply (jcdctmgr.c
    compute_reciprocal, 16-bit DCTELEM); the port divides with rounding as
    libjpeg does. The quotients agree for every divisor 8 x (1..255) and
    every DCT output magnitude of 8-bit samples (< 2^14)."""
    temps = np.arange(0, 1 << 14, dtype=np.int64)
    for q in range(1, 256):
        divisor = q << 3
        b = divisor.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, divisor)
        c = divisor // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= divisor // 2:
            c += 1
        else:
            fq += 1
        turbo = ((temps + c) * fq) >> r
        libjpeg = np.where(temps + divisor // 2 >= divisor, (temps + divisor // 2) // divisor, 0)
        np.testing.assert_array_equal(turbo, libjpeg, err_msg=f"divisor {divisor}")


def test_golden_file_is_what_the_script_writes() -> None:
    committed = np.load(golden.DEFAULT_OUT)
    fresh = golden.build()
    assert sorted(committed.files) == sorted(fresh)
    for key, value in fresh.items():
        if key == "cv2_version":
            continue
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert golden.DEFAULT_OUT.stat().st_size < 200_000


def test_golden_set_holds_on_the_cpu_build() -> None:
    """The check chip_smoke.py runs on the card machine's build."""
    assert chip_smoke.check_jpeg_golden() == {"decode_cases": 23, "encode_cases": 4}
