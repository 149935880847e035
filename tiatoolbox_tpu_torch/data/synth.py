"""Synthetic H&E-like sample data (counterpart of ``tiatoolbox_tpu/data/synth.py:25-140``).

Tissue blobs with nuclei on a white background, composed by Beer-Lambert
from the Ruifrok H&E stain vectors, so stain estimation recovers sensible
matrices. Smoothing uses ``scipy.ndimage`` and the pyramid is written with
the port's TIFF writer, JPEG tiles at Q 90 by default as JAX writes them
(the port's encoder) or deflate tiles. The pixels follow the same recipe
as the JAX package's but are not bit-identical to them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy import ndimage

from tiatoolbox_tpu_torch.utils.transforms import imresize
from tiatoolbox_tpu_torch.wsicore.tiffio import TiffPyramidWriter

# Ruifrok & Johnston H&E stain vectors (rows: haematoxylin, eosin).
_HE_STAINS = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])


def synthetic_he_patch(
    size: tuple[int, int] = (256, 256),
    seed: int = 0,
    tissue_fraction: float = 0.7,
) -> np.ndarray:
    """An H&E-looking uint8 RGB image of ``size`` (width, height)."""
    width, height = size
    rng = np.random.default_rng(seed)

    def smooth_field(scale: int) -> np.ndarray:
        small = rng.random((max(2, height // scale), max(2, width // scale))).astype(
            np.float32
        )
        zoom = (height / small.shape[0], width / small.shape[1])
        field = ndimage.zoom(small, zoom, order=3, mode="nearest", grid_mode=True)
        return np.clip(field[:height, :width], 0, 1)

    tissue = smooth_field(32)
    tissue_mask = tissue > np.quantile(tissue, 1 - tissue_fraction)
    tissue_soft = ndimage.gaussian_filter(tissue_mask.astype(np.float32), 5.0, truncate=3.0)
    eosin_density = smooth_field(16) * tissue_soft * 0.9

    nuclei = np.zeros((height, width), np.float32)
    n_nuclei = min(int(tissue_mask.sum() / 600) + 5, 4000)
    ys, xs = np.nonzero(tissue_mask)
    if len(ys):
        idx = rng.integers(0, len(ys), size=n_nuclei)
        radii = rng.integers(3, 7, size=n_nuclei)
        for y, x, r in zip(ys[idx], xs[idx], radii):
            y0, y1 = max(y - r, 0), min(y + r + 1, height)
            x0, x1 = max(x - r, 0), min(x + r + 1, width)
            yy, xx = np.ogrid[y0:y1, x0:x1]
            nuclei[y0:y1, x0:x1][(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = 1.0
    nuclei = ndimage.gaussian_filter(nuclei, 1.1, truncate=2.0)

    haem = _HE_STAINS[0].astype(np.float32)
    eos = (_HE_STAINS[1] * 0.8).astype(np.float32)
    out = np.empty((height, width, 3), np.uint8)
    block = max(1, (32 << 20) // (width * 3 * 4))
    for y0 in range(0, height, block):
        y1 = min(y0 + block, height)
        od = nuclei[y0:y1, :, None] * haem
        od += eosin_density[y0:y1, :, None] * eos
        rgb = np.exp(-od) * 255.0
        rgb += rng.normal(0, 2.0, rgb.shape).astype(np.float32)
        out[y0:y1] = np.clip(rgb, 0, 255).astype(np.uint8)
    return out


def make_synthetic_slide(
    path: str | Path,
    size: tuple[int, int] = (2048, 1536),
    mpp: float = 0.5,
    objective_power: float = 20,
    tile_size: int = 256,
    levels: int | None = None,
    seed: int = 11,
    compression: str = "jpeg",
    jpeg_quality: int = 90,
) -> Path:
    """Write a pyramidal tiled TIFF synthetic slide to ``path``.

    A baseline level plus 2x-downsampled levels until the image fits in one
    tile; mpp and power go into the resolution tags and an Aperio-style
    ImageDescription ("JPEG/RGB Q=90" for JPEG tiles, as JAX's
    ``synth.py:126-138``, "Deflate/RGB" for deflate ones).
    """
    path = Path(path)
    width, height = size
    images = [synthetic_he_patch(size=(width, height), seed=seed)]
    if levels is None:
        levels = 1
        w, h = width, height
        while max(w, h) > tile_size:
            w, h = max(1, w // 2), max(1, h // 2)
            levels += 1
    for _ in range(levels - 1):
        prev = images[-1]
        out_wh = (max(1, prev.shape[1] // 2), max(1, prev.shape[0] // 2))
        images.append(imresize(prev, output_size=out_wh, interpolation="area"))
    codec = f"JPEG/RGB Q={jpeg_quality}" if compression == "jpeg" else "Deflate/RGB"
    description = (
        f"Aperio Image Library v0.0.0\n"
        f"{width}x{height} [0,0 {width}x{height}] ({tile_size}x{tile_size})"
        f" {codec}|AppMag = {objective_power:g}|MPP = {mpp:g}"
    )
    TiffPyramidWriter(
        path,
        tile_size=tile_size,
        description=description,
        mpp=(mpp, mpp),
        compression=compression,
        jpeg_quality=jpeg_quality,
    ).write(images)
    return path
