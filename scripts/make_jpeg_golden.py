"""Write the JPEG golden set that holds the port's codec on the card to OpenCV.

    python scripts/make_jpeg_golden.py [--out tiatoolbox_tpu_torch/data/jpeg_golden.npz]

Needs OpenCV (``cv2``), whose bundled libjpeg-turbo is the reference. The
set holds small streams covering the decoder's matrix (qualities 50-100,
sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, grey, restart intervals,
optimised Huffman tables, different luma and chroma quality, an
abbreviated stream merged with split-off tables, RGB-coded streams by
component ids and by an Adobe marker, 16-bit quantisation tables, a stream
without Huffman tables, a stream cut short and closed by EOI), each with
``cv2.imdecode``'s pixels (RGB), and a few fixed seeded images with the
bytes ``cv2.imencode`` writes for them. ``chip_smoke.py`` checks the
card's build of ``csrc/jpegdec.cpp`` and ``csrc/jpegenc.cpp`` against it;
``tests/test_torch_jpeg.py`` checks that the committed file is what this
script writes.
"""

from __future__ import annotations

import argparse
import io
from pathlib import Path

import sys

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tiatoolbox_tpu_torch.wsicore.tiffio import _merge_jpeg_tables  # noqa: E402
DEFAULT_OUT = ROOT / "tiatoolbox_tpu_torch" / "data" / "jpeg_golden.npz"

SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}


def sample_image(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Smooth colour fields with noise and a few hard edges, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack(
        [
            128 + 90 * np.sin(xx / 5.0 + k) * np.cos(yy / 7.0 - k) + 25 * ((xx + 2 * yy) % 11 < 3)
            for k in range(channels)
        ],
        axis=-1,
    )
    out = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
    return out[:, :, 0] if channels == 1 else out


def _segments(stream: bytes) -> list[tuple[int, int, int]]:
    """(marker, start, end) of each marker segment from after SOI through SOS."""
    out, i = [], 2
    while True:
        marker = stream[i + 1]
        length = int.from_bytes(stream[i + 2 : i + 4], "big")
        out.append((marker, i, i + 2 + length))
        if marker == 0xDA:
            return out
        i += 2 + length


def edited_streams(stream: bytes) -> dict[str, bytes]:
    """Variants of a JFIF 4:2:0 colour stream of ``cv2.imencode``: tables split
    off (the tile and the table stream), RGB coding by component ids and by
    an Adobe marker, 16-bit quantisation tables, no Huffman tables (the
    standard ones are meant), fill bytes before the markers."""
    segs = _segments(stream)
    scan = stream[segs[-1][2] :]
    body = {m: [stream[s:e] for mm, s, e in segs if mm == m] for m in {m for m, _, _ in segs}}
    no_app0 = b"".join(stream[s:e] for m, s, e in segs if m != 0xE0)
    sof = body[0xC0][0]
    sos = body[0xDA][0]
    rgb_sof = bytearray(sof)
    rgb_sos = bytearray(sos)
    for k, cid in enumerate(b"RGB"):
        rgb_sof[10 + 3 * k] = cid
        rgb_sos[5 + 2 * k] = cid

    def dqt16(seg: bytes) -> bytes:
        payload, rest = b"", seg[4:]
        while rest:
            table, vals, rest = rest[0], rest[1:65], rest[65:]
            payload += bytes([0x10 | (table & 15)]) + b"".join(int(v).to_bytes(2, "big") for v in vals)
        return b"\xff\xdb" + (len(payload) + 2).to_bytes(2, "big") + payload

    tables = b"\xff\xd8" + b"".join(body[0xDB] + body[0xC4]) + b"\xff\xd9"
    tile = b"\xff\xd8" + b"".join(stream[s:e] for m, s, e in segs if m not in (0xDB, 0xC4)) + scan
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return {
        "tables": tables,
        "tile": tile,
        "rgb_ids": b"\xff\xd8"
        + no_app0.replace(sof, bytes(rgb_sof)).replace(sos, bytes(rgb_sos))
        + scan,
        "adobe_rgb": b"\xff\xd8" + adobe + no_app0 + scan,
        "dqt16": b"\xff\xd8"
        + b"".join(dqt16(stream[s:e]) if m == 0xDB else stream[s:e] for m, s, e in segs)
        + scan,
        "no_dht": b"\xff\xd8" + b"".join(stream[s:e] for m, s, e in segs if m != 0xC4) + scan,
        "fill_ff": b"\xff\xd8" + b"".join(b"\xff\xff" + stream[s:e] for m, s, e in segs) + scan,
        "cut_eoi": stream[: len(stream) * 2 // 3] + b"\xff\xd9",
    }


def decode_cases() -> dict[str, bytes]:
    import cv2

    def enc(img: np.ndarray, *params: int) -> bytes:
        bgr = img if img.ndim == 2 else img[:, :, ::-1]
        ok, buf = cv2.imencode(".jpg", bgr, list(params))
        assert ok
        return buf.tobytes()

    q = cv2.IMWRITE_JPEG_QUALITY
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    img = sample_image(24, 40, seed=1)
    cases = {}
    for name, factor in SAMPLINGS.items():
        cases[f"q90_{name}"] = enc(img, q, 90, sf, factor)
    for quality in (50, 75, 95, 100):
        cases[f"q{quality}_420"] = enc(img, q, quality)
    cases["q90_420_1x1"] = enc(sample_image(1, 1, seed=2), q, 90)
    cases["q90_420_7x13"] = enc(sample_image(7, 13, seed=3), q, 90)
    cases["q90_411_17x33"] = enc(sample_image(17, 33, seed=4), q, 90, sf, SAMPLINGS["411"])
    cases["grey_q90"] = enc(sample_image(24, 40, seed=5, channels=1), q, 90)
    cases["rst_2"] = enc(img, q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    cases["optimize"] = enc(img, q, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    cases["luma90_chroma40"] = enc(
        img, cv2.IMWRITE_JPEG_LUMA_QUALITY, 90, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 40
    )
    edited = edited_streams(cases["q90_420"])
    cases["abbreviated_merged"] = _merge_jpeg_tables(edited.pop("tables"), edited.pop("tile"))
    cases.update(edited)
    return cases


def encode_cases() -> dict[str, tuple[np.ndarray, int]]:
    return {
        "rgb_37x53_q90": (sample_image(37, 53, seed=6), 90),
        "rgb_16x16_q100": (sample_image(16, 16, seed=7), 100),
        "rgb_34x30_q50": (sample_image(34, 30, seed=8), 50),
        "grey_31x17_q75": (sample_image(31, 17, seed=9, channels=1), 75),
    }


def _pack(chunks: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(chunks) + 1, np.int64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    return np.frombuffer(b"".join(chunks), np.uint8).copy(), offsets


def build() -> dict[str, np.ndarray]:
    """The golden set's arrays (what ``--out`` holds)."""
    import cv2

    dec = decode_cases()
    names = sorted(dec)
    pixels, shapes = [], []
    for name in names:
        img = cv2.imdecode(np.frombuffer(dec[name], np.uint8), cv2.IMREAD_UNCHANGED)
        assert img is not None, name
        img = img[:, :, None] if img.ndim == 2 else img[:, :, ::-1]
        pixels.append(np.ascontiguousarray(img).tobytes())
        shapes.append(img.shape)
    dec_blob, dec_offsets = _pack([dec[n] for n in names])
    pix_blob, pix_offsets = _pack(pixels)

    enc = encode_cases()
    enc_names = sorted(enc)
    inputs, streams, in_shapes, qualities = [], [], [], []
    for name in enc_names:
        img, quality = enc[name]
        bgr = img if img.ndim == 2 else img[:, :, ::-1]
        streams.append(cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes())
        inputs.append(img.tobytes())
        in_shapes.append((*img.shape[:2], 1 if img.ndim == 2 else 3))
        qualities.append(quality)
    in_blob, in_offsets = _pack(inputs)
    enc_blob, enc_offsets = _pack(streams)
    return {
        "dec_names": np.array(names),
        "dec_blob": dec_blob,
        "dec_offsets": dec_offsets,
        "dec_pixels": pix_blob,
        "dec_pixel_offsets": pix_offsets,
        "dec_shapes": np.array(shapes, np.int64),
        "enc_names": np.array(enc_names),
        "enc_inputs": in_blob,
        "enc_input_offsets": in_offsets,
        "enc_shapes": np.array(in_shapes, np.int64),
        "enc_quality": np.array(qualities, np.int64),
        "enc_blob": enc_blob,
        "enc_offsets": enc_offsets,
        "cv2_version": np.array(cv2.__version__),
    }


def serialise(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    args.out.write_bytes(serialise(build()))
    print(f"{args.out}: {args.out.stat().st_size} bytes")


if __name__ == "__main__":
    main()
