"""Synthetic H&E-like sample data (counterpart of ``tiatoolbox_tpu/data/synth.py``).

Tissue blobs with nuclei on a white background, composed by Beer-Lambert
from the Ruifrok H&E stain vectors, so stain estimation recovers sensible
matrices. Smoothing uses ``scipy.ndimage`` and the pyramid is written with
the port's TIFF writer, JPEG tiles at Q 90 by default as JAX writes them
(the port's encoder) or deflate tiles. The pixels follow the same recipe
as the JAX package's but are not bit-identical to them;
``synthetic_he_patch_exact`` gives JAX's pixels (to one level in about one
value in two million), for ``KatherPatchDataset``'s stand-in.

``make_synthetic_dicom`` writes a WSI DICOM instance as JAX's
(``synth.py:142-289``) does, native frames or, with ``compression="jpeg"``,
JPEG-baseline frames encapsulated with or without a Basic Offset Table;
``write_synthetic_mrxs`` writes a MIRAX tree as JAX's test helper
``tests/mirax_synth.py`` does, its JPEG tiles from the port's encoder (the
same bytes as ``cv2.imencode``). Both take the pixels to write, so the
smoke test can store one slide in every container.
"""

from __future__ import annotations

from pathlib import Path

import struct

import numpy as np
from scipy import ndimage

from tiatoolbox_tpu_torch import native

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


def _cubic_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Source indices and weights of cv2's ``INTER_CUBIC`` (A = -0.75, edges clamped)."""
    d = np.arange(n_out)
    fx = ((d + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(int)
    x = (fx - sx).astype(np.float64)
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    weights = np.stack([c0, c1, c2, 1 - c0 - c1 - c2], 1)
    return np.clip(sx[:, None] - 1 + np.arange(4)[None], 0, n_in - 1), weights


def _resize_cubic(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2's float32 cubic upsampling, summed in float64 and rounded once."""
    xi, xw = _cubic_taps(src.shape[1], width)
    yi, yw = _cubic_taps(src.shape[0], height)
    rows = (src.astype(np.float64)[:, xi] * xw[None]).sum(-1)
    return (rows[yi] * yw[:, :, None]).sum(1).astype(np.float32)


def _gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), 0)`` of a float32 image, in cv2's
    float32 order: the row pass tap by tap, the column pass by symmetric tap
    pairs with a fused multiply-add, edges ``BORDER_REFLECT_101``."""
    if ksize == 5:
        kernel = np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32)  # cv2's fixed 5-tap table
    else:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
        x = np.arange(ksize) - (ksize - 1) * 0.5
        t = np.exp(-0.5 / (sigma * sigma) * x * x)
        kernel = (t / t.sum()).astype(np.float32)
    r = ksize // 2
    h, w = img.shape
    p = np.pad(img, ((0, 0), (r, r)), mode="reflect")
    rows = (p[:, :w] * kernel[0]).astype(np.float32)
    for i in range(1, ksize):
        rows = (rows + p[:, i : i + w] * kernel[i]).astype(np.float32)
    p = np.pad(rows, ((r, r), (0, 0)), mode="reflect")
    out = (p[r : r + h] * kernel[r]).astype(np.float32)
    for i in range(1, r + 1):
        pair = (p[r + i : r + i + h] + p[r - i : r - i + h]).astype(np.float32)
        out = (pair.astype(np.float64) * np.float64(kernel[r + i]) + out).astype(np.float32)
    return out


def synthetic_he_patch_exact(
    size: tuple[int, int] = (256, 256),
    seed: int = 0,
    tissue_fraction: float = 0.7,
) -> np.ndarray:
    """JAX's ``synthetic_he_patch`` (``tiatoolbox_tpu/data/synth.py:25-93``), its pixels.

    The same draws in the same order as JAX's, with cv2's steps reproduced:
    the cubic upsampling of the noise fields (summed in float64 where cv2
    runs Intel IPP's float32 kernel, so a field value may differ by one
    float32 rounding), the float32 Gaussian blurs, the filled nuclei drawn
    by the port's rasteriser (``native.circle``). On the 128 patches of 224²
    of ``KatherPatchDataset``'s stand-in, 10 of 19.3 million values differ
    from JAX's, each by one level. ``synthetic_he_patch`` keeps its own
    recipe, which the port's slides and tests are built on.
    """
    width, height = size
    rng = np.random.default_rng(seed)

    def smooth_field(scale: int) -> np.ndarray:
        small = rng.random((max(2, height // scale), max(2, width // scale))).astype(np.float32)
        return np.clip(_resize_cubic(small, width, height), 0, 1)

    tissue = smooth_field(32)
    tissue_mask = tissue > np.quantile(tissue, 1 - tissue_fraction)
    tissue_soft = _gaussian_blur(tissue_mask.astype(np.float32), 31)
    eosin_density = smooth_field(16)
    eosin_density *= tissue_soft
    eosin_density *= 0.9
    nuclei = np.zeros((height, width), np.uint8)
    n_nuclei = min(int(tissue_mask.sum() / 600) + 5, 4000)
    ys, xs = np.nonzero(tissue_mask)
    if len(ys):
        idx = rng.integers(0, len(ys), size=n_nuclei)
        for y, x in zip(ys[idx], xs[idx]):
            native.circle(nuclei, (int(x), int(y)), int(rng.integers(3, 7)), (1,))
    nuclei = _gaussian_blur(nuclei.astype(np.float32), 5)
    haem = _HE_STAINS[0].astype(np.float32)
    eos = (_HE_STAINS[1] * 0.8).astype(np.float32)
    out = np.empty((height, width, 3), np.uint8)
    block = max(1, (32 << 20) // (width * 3 * 4))
    for y0 in range(0, height, block):
        y1 = min(y0 + block, height)
        od = nuclei[y0:y1, :, None] * haem
        od += eosin_density[y0:y1, :, None] * eos
        np.negative(od, out=od)
        rgb = np.exp(od, out=od)
        rgb *= 255.0
        rgb += rng.normal(0, 2.0, rgb.shape).astype(np.float32)
        np.clip(rgb, 0, 255, out=rgb)
        out[y0:y1] = rgb.astype(np.uint8)
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


def _dicom_element(group, elem, vr, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00"
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _dicom_element_implicit(group, elem, vr, value: bytes) -> bytes:
    """Implicit VR LE: tag + 4-byte length, no VR bytes (vr ignored)."""
    del vr
    if len(value) % 2:
        value += b"\x00"
    return struct.pack("<HHI", group, elem, len(value)) + value


def _dicom_seq_item(content: bytes) -> bytes:
    return struct.pack("<HHI", 0xFFFE, 0xE000, len(content)) + content


def _encapsulated_pixel_data(frames: list[bytes], *, offset_table: bool) -> bytes:
    """PixelData (7FE0,0010) of undefined length: the Basic Offset Table item
    (empty, or each frame's offset), one item a frame, the delimiter."""
    frames = [f + b"\x00" if len(f) % 2 else f for f in frames]
    offsets, pos = [], 0
    for frame in frames:
        offsets.append(pos)
        pos += 8 + len(frame)
    bot = struct.pack(f"<{len(offsets)}I", *offsets) if offset_table else b""
    head = struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
    items = b"".join(_dicom_seq_item(f) for f in [bot, *frames])
    return head + items + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)


def make_synthetic_dicom(  # noqa: C901, PLR0912, PLR0915
    path: str | Path,
    size: tuple[int, int] = (512, 384),
    frame_size: int = 128,
    mpp: float = 0.5,
    seed: int = 21,
    *,
    sparse: bool = False,
    sparse_keep=None,
    n_concat: int = 1,
    explicit: bool = True,
    image: np.ndarray | None = None,
    compression: str = "none",
    jpeg_quality: int = 90,
    offset_table: bool = False,
) -> Path | list[Path]:
    """Write a minimal WSI DICOM instance (JAX ``synth.py:168-289``).

    Explicit or implicit VR little endian, RGB frames of ``frame_size``
    squared, edge frames zero-padded.

    Args:
        sparse: Emit TILED_SPARSE organisation: only tiles selected by
            ``sparse_keep`` are stored, each with its
            PlanePositionSlideSequence position.
        sparse_keep: ``(fy, fx) -> bool`` choosing the stored cells (default:
            a checkerboard).
        n_concat: Split the frames over this many concatenated instances
            (shared ConcatenationUID and frame offsets), written to ``path``
            with suffixes ``_p{k}.dcm``; their paths are returned.
        explicit: Explicit VR LE (default) or implicit VR LE (the file meta
            stays explicit, as the standard says).
        image: The uint8 RGB pixels; ``synthetic_he_patch(size, seed)`` when
            None (``size`` and ``seed`` then set them).
        compression: "none" (native frames) or "jpeg" (baseline JPEG frames,
            transfer syntax 1.2.840.10008.1.2.4.50, explicit VR only).
        jpeg_quality: The JPEG quality, 1-100.
        offset_table: Fill the Basic Offset Table of JPEG frames.
    """
    if compression not in ("none", "jpeg"):
        msg = f"compression must be 'none' or 'jpeg', got {compression!r}."
        raise ValueError(msg)
    if compression == "jpeg" and not explicit:
        msg = "Encapsulated (JPEG) pixel data needs explicit VR."
        raise ValueError(msg)
    path = Path(path)
    img = synthetic_he_patch(size=size, seed=seed) if image is None else np.asarray(image, np.uint8)
    height, width = img.shape[:2]
    frames_across = -(-width // frame_size)
    frames_down = -(-height // frame_size)
    if sparse and sparse_keep is None:
        sparse_keep = lambda fy, fx: (fy + fx) % 2 == 0  # noqa: E731
    frames = []
    positions = []  # 1-based (row_px, col_px) of each stored frame
    for fy in range(frames_down):
        for fx in range(frames_across):
            if sparse and not sparse_keep(fy, fx):
                continue
            tile = np.zeros((frame_size, frame_size, 3), np.uint8)
            block = img[
                fy * frame_size : (fy + 1) * frame_size,
                fx * frame_size : (fx + 1) * frame_size,
            ]
            tile[: block.shape[0], : block.shape[1]] = block
            if compression == "jpeg":
                frames.append(native.encode_jpeg(tile, jpeg_quality))
            else:
                frames.append(tile.tobytes())
            positions.append((fy * frame_size + 1, fx * frame_size + 1))

    element = _dicom_element if explicit else _dicom_element_implicit
    if compression == "jpeg":
        ts = b"1.2.840.10008.1.2.4.50"
    else:
        ts = b"1.2.840.10008.1.2.1" if explicit else b"1.2.840.10008.1.2"
    meta = _dicom_element(0x0002, 0x0010, b"UI", ts)
    mm = mpp / 1000.0
    spacing = f"{mm:.6f}\\{mm:.6f}".encode()
    concat_uid = b"1.2.826.0.1.3680043.99.1.42" if n_concat > 1 else None
    photometric = b"YBR_FULL_422" if compression == "jpeg" else b"RGB"

    per_part = -(-len(frames) // n_concat)
    paths = []
    for part in range(n_concat):
        lo = part * per_part
        hi = min(lo + per_part, len(frames))
        part_frames = frames[lo:hi]
        if not part_frames:
            continue
        elements = [
            element(0x0008, 0x0008, b"CS", b"ORIGINAL\\PRIMARY\\VOLUME"),
            element(0x0028, 0x0002, b"US", struct.pack("<H", 3)),
            element(0x0028, 0x0004, b"CS", photometric),
            element(0x0028, 0x0008, b"IS", str(len(part_frames)).encode()),
            element(0x0028, 0x0010, b"US", struct.pack("<H", frame_size)),
            element(0x0028, 0x0011, b"US", struct.pack("<H", frame_size)),
            element(0x0028, 0x0030, b"DS", spacing),
        ]
        if concat_uid:
            elements += [
                element(0x0020, 0x9161, b"UI", concat_uid),
                element(0x0020, 0x9162, b"US", struct.pack("<H", part + 1)),
                element(0x0020, 0x9228, b"UL", struct.pack("<I", lo)),
            ]
        elements += [
            element(0x0020, 0x9311, b"CS", b"TILED_SPARSE" if sparse else b"TILED_FULL"),
        ]
        if sparse:
            items = b"".join(
                _dicom_seq_item(
                    element(
                        0x0048,
                        0x021A,
                        b"SQ",
                        _dicom_seq_item(
                            element(0x0048, 0x021E, b"SL", struct.pack("<i", col))
                            + element(0x0048, 0x021F, b"SL", struct.pack("<i", row))
                        ),
                    )
                )
                for row, col in positions[lo:hi]
            )
            elements.append(element(0x5200, 0x9230, b"SQ", items))
        elements += [
            element(0x0048, 0x0006, b"UL", struct.pack("<I", width)),
            element(0x0048, 0x0007, b"UL", struct.pack("<I", height)),
        ]
        if compression == "jpeg":
            elements.append(_encapsulated_pixel_data(part_frames, offset_table=offset_table))
        else:
            elements.append(element(0x7FE0, 0x0010, b"OB", b"".join(part_frames)))
        out_path = path if n_concat == 1 else path.with_name(f"{path.stem}_p{part}.dcm")
        with out_path.open("wb") as fh:
            fh.write(b"\x00" * 128 + b"DICM")
            fh.write(meta)
            fh.write(b"".join(elements))
        paths.append(out_path)
    return paths if n_concat > 1 else path


MIRAX_SLIDE_VERSION = "01.02"
MIRAX_SLIDE_ID = "SYNTHETIC-0001"


def mirax_tile_pixels(level: int, tx: int, ty: int, tile: int) -> np.ndarray:
    """The test helper's deterministic RGB camera tile (``tests/mirax_synth.py``)."""
    img = np.zeros((tile, tile, 3), np.uint8)
    img[..., 0] = 40 * level + 10
    img[..., 1] = (60 * tx + 30) % 256
    img[..., 2] = (60 * ty + 30) % 256
    img[: tile // 4, : tile // 4] = 255  # corner marker
    return img


def write_synthetic_mrxs(  # noqa: C901, PLR0912, PLR0915
    path: str | Path,
    grid_nx: int = 4,
    grid_ny: int = 3,
    tile: int = 64,
    n_levels: int = 2,
    mpp: float = 0.5,
    *,
    missing_tiles: tuple = (),
    overlap: int = 0,
    fill_bgr: int = 16777215,
    n_data_files: int = 1,
    corrupt_tiles: tuple = (),
    level_images: list[np.ndarray] | None = None,
    jpeg_quality: int = 95,
) -> Path:
    """Write ``<path>.mrxs`` and its data directory; returns the ``.mrxs`` path.

    Tiles are ``mirax_tile_pixels`` unless ``level_images`` gives each
    level's pixels: level ``L``'s tile ``(tx, ty)`` is then the ``tile``
    squared block at ``(tx * tile, ty * tile)`` of ``level_images[L]``
    (zero-padded at the edges). ``missing_tiles`` drops index entries,
    ``corrupt_tiles`` writes garbage bytes for an entry (each a ``(level,
    tx, ty)``), ``fill_bgr`` sets the fill colour, ``overlap`` the camera
    overlap, and ``n_data_files`` spreads tiles round-robin over data files.
    """
    path = Path(path)
    mrxs = path.with_suffix(".mrxs")
    data_dir = mrxs.parent / mrxs.stem
    data_dir.mkdir(parents=True, exist_ok=True)
    mrxs.write_bytes(b"MIRAX synthetic stub")

    def pixels(lvl: int, tx: int, ty: int) -> np.ndarray:
        if level_images is None:
            return mirax_tile_pixels(lvl, tx, ty, tile)
        block = level_images[lvl][ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile]
        out = np.zeros((tile, tile, 3), np.uint8)
        out[: block.shape[0], : block.shape[1]] = block
        return out

    level_entries: list[list[tuple[int, int, int, int]]] = [[] for _ in range(n_levels)]
    data_paths = [data_dir / f"Data{k:04d}.dat" for k in range(n_data_files)]
    handles = [p.open("wb") for p in data_paths]
    try:
        tile_counter = 0
        for lvl in range(n_levels):
            step = 2**lvl
            for gy in range(0, grid_ny, step):
                for gx in range(0, grid_nx, step):
                    key = (lvl, gx // step, gy // step)
                    if key in missing_tiles:
                        continue
                    if key in corrupt_tiles:
                        payload = b"\xde\xad\xbe\xef" * 16
                    else:
                        payload = native.encode_jpeg(pixels(*key), jpeg_quality)
                    fileno = tile_counter % n_data_files
                    fh = handles[fileno]
                    offset = fh.tell()
                    fh.write(payload)
                    tile_counter += 1
                    level_entries[lvl].append((gy * grid_nx + gx, offset, len(payload), fileno))
        # one nonhierarchical entry: a small "thumbnail" JPEG
        thumb = native.encode_jpeg(np.full((32, 32, 3), 128, np.uint8), 95)
        thumb_entry = (0, handles[0].tell(), len(thumb), 0)
        handles[0].write(thumb)
    finally:
        for fh in handles:
            fh.close()

    lines = [
        "[GENERAL]",
        f"SLIDE_VERSION = {MIRAX_SLIDE_VERSION}",
        f"SLIDE_ID = {MIRAX_SLIDE_ID}",
        f"IMAGENUMBER_X = {grid_nx}",
        f"IMAGENUMBER_Y = {grid_ny}",
        "",
        "[HIERARCHICAL]",
        "HIER_COUNT = 1",
        "NONHIER_COUNT = 1",
        "INDEXFILE = Index.dat",
        "HIER_0_NAME = Slide zoom level",
        f"HIER_0_COUNT = {n_levels}",
    ]
    for lvl in range(n_levels):
        lines += [
            f"HIER_0_VAL_{lvl} = ZoomLevel_{lvl}",
            f"HIER_0_VAL_{lvl}_SECTION = LAYER_0_LEVEL_{lvl}_SECTION",
        ]
    lines += [
        "NONHIER_0_NAME = Scan data layer",
        "NONHIER_0_COUNT = 1",
        "NONHIER_0_VAL_0 = ScanDataLayer_SlideThumbnail",
        "",
        "[DATAFILE]",
        f"FILE_COUNT = {n_data_files}",
        *[f"FILE_{k} = Data{k:04d}.dat" for k in range(n_data_files)],
        "",
    ]
    for lvl in range(n_levels):
        lines += [
            f"[LAYER_0_LEVEL_{lvl}_SECTION]",
            f"DIGITIZER_WIDTH = {tile}",
            f"DIGITIZER_HEIGHT = {tile}",
            f"OVERLAP_X = {overlap}",
            f"OVERLAP_Y = {overlap}",
            f"MICROMETER_PER_PIXEL_X = {mpp * 2**lvl}",
            f"MICROMETER_PER_PIXEL_Y = {mpp * 2**lvl}",
            "IMAGE_FORMAT = JPEG",
            f"IMAGE_FILL_COLOR_BGR = {fill_bgr}",
            "",
        ]
    (data_dir / "Slidedat.ini").write_text("\n".join(lines), encoding="utf-8")

    # Index.dat: header | hier_root, nonhier_root | hier slot table |
    # nonhier slot table | pages
    header = MIRAX_SLIDE_VERSION.encode() + MIRAX_SLIDE_ID.encode()
    hier_root = len(header) + 8
    nonhier_root = hier_root + 4 * n_levels
    pages_start = nonhier_root + 4
    blob = bytearray(header)
    blob += struct.pack("<ii", hier_root, nonhier_root)
    page_offsets = []
    pages = bytearray()
    for lvl in range(n_levels):
        page_offsets.append(pages_start + len(pages))
        entries = level_entries[lvl]
        pages += struct.pack("<ii", len(entries), 0)
        for entry in entries:
            pages += struct.pack("<iiii", *entry)
    nonhier_page_offset = pages_start + len(pages)
    pages += struct.pack("<ii", 1, 0)
    pages += struct.pack("<iiii", *thumb_entry)
    for off in page_offsets:
        blob += struct.pack("<i", off)
    blob += struct.pack("<i", nonhier_page_offset)
    blob += pages
    (data_dir / "Index.dat").write_bytes(bytes(blob))
    return mrxs
