"""Write the JPEG 2000 golden set that holds the port's codec on the card to OpenCV.

    python scripts/make_j2k_golden.py [--out tiatoolbox_tpu_torch/data/j2k_golden.npz]

Needs OpenCV (``cv2``), whose bundled OpenJPEG is the reference, and the
JAX package (its ``encode_tiled_j2k`` writes the tiled stream). The set
holds small codestreams, each with ``cv2.imdecode``'s pixels (RGB):

- streams cv2 writes: lossless, its lossy default and two lower rates,
  grey, odd sizes, and a tiled stream stitched by JAX's ``encode_tiled_j2k``;
- the port encoder's option matrix (``native.encode_j2k``): every
  code-block style flag, every progression order with precincts and
  layers, SOP/EPH, tile-parts, no colour transform, and the irreversible
  9/7 path;
- ``cv2.IMREAD_REDUCED_COLOR_{2,4,8}`` pixels of one stream, which the
  port gives as its decode shrunk by ``utils.transforms.shrink_linear_exact``.

``chip_smoke.py`` checks the card machine's build of ``csrc/j2kdec.cpp``
against it; ``tests/test_torch_j2k_codec.py`` checks that the committed
file is what this script writes.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEFAULT_OUT = ROOT / "tiatoolbox_tpu_torch" / "data" / "j2k_golden.npz"

# the port encoder's options for each case of the matrix
ENCODER_CASES = {
    "enc_lossless": {},
    "enc_bypass": {"cblk_style": ("bypass",)},
    "enc_reset": {"cblk_style": ("reset",)},
    "enc_termall": {"cblk_style": ("termall",)},
    "enc_vertical_causal": {"cblk_style": ("vertical_causal",)},
    "enc_predictable": {"cblk_style": ("predictable",)},
    "enc_segsym": {"cblk_style": ("segsym",)},
    "enc_all_styles": {"cblk_style": ("bypass", "reset", "termall", "vertical_causal", "predictable", "segsym")},
    "enc_bypass_predictable": {"cblk_style": ("bypass", "predictable")},
    "enc_sop_eph_layers": {"sop": True, "eph": True, "layers": 3},
    "enc_tile_parts": {"tile_size": 32, "packets_per_tile_part": 4, "progression": "RPCL"},
    "enc_no_mct": {"mct": False},
    "enc_small_blocks": {"levels": 3, "code_block": (32, 16)},
    "enc_97": {"irreversible": True},
    "enc_97_coarse": {"irreversible": True, "step": 6.0},
    "enc_97_styles": {"irreversible": True, "cblk_style": ("bypass", "termall", "segsym"), "layers": 2},
    "enc_97_grey": {"irreversible": True, "grey": True},
}
for _prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
    ENCODER_CASES[f"enc_{_prog.lower()}_precincts"] = {
        "progression": _prog,
        "layers": 2,
        "precincts": [(4, 4), (4, 4), (4, 3), (3, 3), (3, 3), (3, 3)],
        "code_block": (16, 16),
    }


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


def cv2_pixels(stream: bytes, flags=None) -> np.ndarray:
    """``cv2.imdecode``'s pixels of a stream, ``[h, w, c]`` in RGB order."""
    import cv2

    img = cv2.imdecode(np.frombuffer(stream, np.uint8), cv2.IMREAD_UNCHANGED if flags is None else flags)
    if img is None:
        msg = "cv2 could not decode a golden stream."
        raise RuntimeError(msg)
    return img[:, :, None] if img.ndim == 2 else img[:, :, ::-1]


def cv2_stream(image: np.ndarray, params=()) -> bytes:
    import cv2

    bgr = image if image.ndim == 2 else np.ascontiguousarray(image[:, :, ::-1])
    ok, buf = cv2.imencode(".jp2", bgr, list(params))
    if not ok:
        msg = "cv2 could not encode a golden stream."
        raise RuntimeError(msg)
    return buf.tobytes()


def cases() -> list[tuple[str, bytes, np.ndarray]]:
    """(name, stream, cv2's pixels) for each decode case."""
    import cv2

    from tiatoolbox_tpu.wsicore.jp2 import encode_tiled_j2k
    from tiatoolbox_tpu_torch import native

    x1000 = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
    out = []
    colour = sample_image(40, 48, 1)
    for name, params in (("lossless", (x1000, 1000)), ("lossy_default", ()), ("lossy_200", (x1000, 200)),
                         ("lossy_50", (x1000, 50))):
        stream = cv2_stream(colour, params)
        out.append((f"cv2_{name}", stream, cv2_pixels(stream)))
    grey = sample_image(37, 45, 2, channels=1)
    for name, params in (("grey_lossless", (x1000, 1000)), ("grey_lossy", ())):
        stream = cv2_stream(grey, params)
        out.append((f"cv2_{name}", stream, cv2_pixels(stream)))
    for h, w in ((33, 47), (65, 35)):
        stream = cv2_stream(sample_image(h, w, h), ())
        out.append((f"cv2_odd_{h}x{w}", stream, cv2_pixels(stream)))
    tiled = encode_tiled_j2k(sample_image(96, 100, 3), tile_size=64)
    out.append(("jax_tiled", tiled, cv2_pixels(tiled)))
    image = sample_image(32, 40, 4)
    for name, opts in ENCODER_CASES.items():
        opts = dict(opts)
        src = image[:, :, 0] if opts.pop("grey", False) else image
        stream = native.encode_j2k(src, **opts)
        out.append((name, stream, cv2_pixels(stream)))
    return out


def reduced_cases() -> tuple[bytes, list[tuple[int, np.ndarray]]]:
    """One stream and cv2's IMREAD_REDUCED_COLOR pixels at 2, 4 and 8."""
    import cv2

    stream = cv2_stream(sample_image(75, 93, 5), ())
    flags = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}
    return stream, [(s, cv2_pixels(stream, flags[s])) for s in (2, 4, 8)]


def _pack(chunks: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(chunks) + 1, np.int64)
    offsets[1:] = np.cumsum([c.size for c in chunks])
    return np.concatenate([c.reshape(-1) for c in chunks]).astype(np.uint8), offsets


def build() -> dict[str, np.ndarray]:
    """The golden arrays."""
    decode = cases()
    blob, offsets = _pack([np.frombuffer(s, np.uint8) for _, s, _ in decode])
    pixels, pixel_offsets = _pack([p for _, _, p in decode])
    reduced_stream, reduced = reduced_cases()
    rpixels, rpixel_offsets = _pack([p for _, p in reduced])
    return {
        "names": np.array([n for n, _, _ in decode]),
        "blob": blob,
        "offsets": offsets,
        "pixels": pixels,
        "pixel_offsets": pixel_offsets,
        "shapes": np.array([p.shape for _, _, p in decode], np.int64),
        "reduced_stream": np.frombuffer(reduced_stream, np.uint8),
        "reduced_factors": np.array([s for s, _ in reduced], np.int64),
        "reduced_pixels": rpixels,
        "reduced_offsets": rpixel_offsets,
        "reduced_shapes": np.array([p.shape for _, p in reduced], np.int64),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    arrays = build()
    np.savez_compressed(args.out, **arrays)
    print(f"{args.out}: {len(arrays['names'])} decode cases, {args.out.stat().st_size} bytes")


if __name__ == "__main__":
    main()
