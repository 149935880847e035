"""Host helpers (counterpart of the parts of ``tiatoolbox_tpu/utils/misc.py`` the port uses).

``get_luminosity_tissue_mask`` (:149) thresholds the L channel of OpenCV's
8-bit RGB->LAB conversion. ``lab_luminosity_u8`` reproduces that channel
without OpenCV, with OpenCV's own fixed-point tables (sRGB gamma table,
cube-root table, 12-bit luminance coefficients, 15-bit L descale): it
equals ``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)[..., 0]`` for every one of
the 2**24 RGB colours.

``get_bounding_box`` (:165) is the box of a mask's nonzero pixels.

``read_locations`` (:193) reads point annotations from an ndarray, ``.npy``,
``.csv`` or ``.json`` into a ``LocationTable``, a small numpy-backed table
with the columns of JAX's DataFrame (the card machine has no pandas).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np

# mpp of a 40x objective; power <-> mpp as 10 / x (``misc.py:97-122``).
_COMMON_POWERS = (1, 1.25, 2, 2.5, 4, 5, 10, 20, 40, 60, 90, 100)


def objective_power2mpp(objective_power) -> float | np.ndarray:
    """Approximate mpp from objective power (10 / power)."""
    return 10.0 / np.asarray(objective_power, dtype=float)


def mpp2objective_power(mpp) -> float | np.ndarray:
    """Approximate objective power from mpp (10 / mpp)."""
    return 10.0 / np.asarray(mpp, dtype=float)


def mpp2common_objective_power(mpp, common_powers=_COMMON_POWERS) -> float | np.ndarray:
    """Approximate objective power(s) from mpp, snapped to common values."""
    op = mpp2objective_power(mpp)
    distances = np.abs(np.subtract.outer(np.atleast_1d(op), common_powers))
    snapped = np.array(common_powers)[np.argmin(distances, axis=-1)]
    if np.isscalar(mpp) or np.ndim(mpp) == 0:
        return float(snapped[0])
    return snapped


def contrast_enhancer(img: np.ndarray, low_p: int = 2, high_p: int = 98) -> np.ndarray:
    """Percentile-stretch contrast enhancement of a uint8 image (``misc.py:129-146``)."""
    if img.dtype != np.uint8:
        msg = "Image should be uint8."
        raise AssertionError(msg)
    img_out = img.copy()
    p_low, p_high = np.percentile(img_out, (low_p, high_p))
    if p_low >= p_high:
        p_low, p_high = np.min(img_out), np.max(img_out)
    if p_high > p_low:
        clipped = np.clip(img_out.astype(np.float64), p_low, p_high)
        img_out = (clipped - p_low) / (p_high - p_low) * 255.0
    return img_out.astype(np.uint8)


def _lab_tables() -> tuple[np.ndarray, np.ndarray]:
    values = np.arange(256, dtype=np.float64) / 255.0
    linear = np.where(
        values <= 0.04045, values / 12.92, ((values + 0.055) / 1.055) ** 2.4
    )
    gamma_tab = np.rint(255.0 * 8 * linear).astype(np.int64)
    x = np.arange(256 * 3 // 2 * 8, dtype=np.float64) / (255.0 * 8)
    cbrt = np.where(x < 216.0 / 24389.0, x * (841.0 / 108.0) + 16.0 / 116.0, np.cbrt(x))
    cbrt_tab = np.rint(32768.0 * cbrt).astype(np.int64)
    return gamma_tab, cbrt_tab


_GAMMA_TAB, _CBRT_TAB = _lab_tables()
_Y_COEFS = (871, 2929, 296)  # round(4096 * (0.212671, 0.715160, 0.072169))


def lab_luminosity_u8(img: np.ndarray) -> np.ndarray:
    """L of 8-bit CIE LAB (0..255) of a uint8 RGB image, bit-exact to OpenCV."""
    rgb = np.asarray(img, np.uint8)
    y = sum(_GAMMA_TAB[rgb[..., k]] * c for k, c in enumerate(_Y_COEFS))
    f_y = _CBRT_TAB[(y + (1 << 11)) >> 12]
    lum = (296 * f_y - 1336934 + (1 << 14)) >> 15
    return np.clip(lum, 0, 255).astype(np.uint8)


def rgb2gray_u8(img: np.ndarray) -> np.ndarray:
    """Greyscale of a uint8 RGB image, bit-exact to OpenCV's ``COLOR_RGB2GRAY``."""
    rgb = np.asarray(img, np.uint8).astype(np.int32)
    gray = rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735
    return ((gray + (1 << 14)) >> 15).astype(np.uint8)


def get_luminosity_tissue_mask(img: np.ndarray, threshold: float) -> np.ndarray:
    """Tissue mask from LAB luminosity below ``threshold``, after contrast stretching."""
    img = img.astype("uint8")
    img = contrast_enhancer(img, low_p=2, high_p=98)
    l_lab = lab_luminosity_u8(img) / 255.0
    tissue_mask = l_lab < threshold
    if tissue_mask.sum() == 0:
        msg = "Empty tissue mask computed."
        raise ValueError(msg)
    return tissue_mask


def get_bounding_box(img: np.ndarray) -> np.ndarray:
    """(start_x, start_y, end_x, end_y) of a mask's nonzero pixels, ends exclusive (``misc.py:165``)."""
    rows = np.any(img, axis=1)
    cols = np.any(img, axis=0)
    r_min, r_max = np.where(rows)[0][[0, -1]]
    c_min, c_max = np.where(cols)[0][[0, -1]]
    return np.array([c_min, r_min, c_max + 1, r_max + 1])


class LocationTable:
    """Columns of equal length by name, each a numpy array (``x``, ``y``,
    ``class``; a JSON table keeps the keys it has)."""

    def __init__(self, columns: dict[str, np.ndarray]) -> None:
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            msg = f"columns of unequal length: { {k: len(v) for k, v in columns.items()} }"
            raise ValueError(msg)
        self._columns = {k: np.asarray(v) for k, v in columns.items()}

    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    @property
    def shape(self) -> tuple[int, int]:
        return len(self), len(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values()))) if self._columns else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __setitem__(self, name: str, values) -> None:
        values = np.asarray(values)
        if values.ndim == 0:
            values = np.full(len(self), values.item(), dtype=values.dtype)
        if self._columns and len(values) != len(self):
            msg = f"column {name!r} has {len(values)} values for {len(self)} rows."
            raise ValueError(msg)
        self._columns[name] = values


def _none_column(n: int) -> np.ndarray:
    return np.full(n, None, dtype=object)


def _csv_column(cells: list[str]) -> np.ndarray:
    """Numbers as pandas infers them (int64 if every cell is an integer, else
    float64, empty cells NaN); anything else as strings."""
    try:
        return np.array([int(c) for c in cells], np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(c) if c != "" else np.nan for c in cells], np.float64)
    except ValueError:
        return np.array(cells, dtype=object)


def _read_csv(path: Path) -> LocationTable:
    with path.open(newline="") as fh:
        rows = [row for row in csv.reader(fh) if row]
    if rows and "x" in rows[0]:
        header, body = rows[0], rows[1:]
    else:
        header, body = ["x", "y", "class"], rows
    width = len(header)
    body = [row + [""] * (width - len(row)) for row in body]
    columns = {name: _csv_column([row[i] for row in body]) for i, name in enumerate(header)}
    table = LocationTable({k: columns[k] for k in ("x", "y") if k in columns})
    table["class"] = columns["class"] if "class" in columns else _none_column(len(body))
    return table


def read_locations(input_table) -> LocationTable:
    """Point annotations as a table with ``x``, ``y`` and ``class`` columns.

    Takes an ``[n, 2]`` or ``[n, 3]`` ndarray, or a ``.npy``, ``.csv`` (with
    an ``x, y[, class]`` header or none) or ``.json`` file (a list of records
    or a dict of columns), as ``misc.py:193-246`` does; ``class`` is None
    where the input has none (a ``.json`` table keeps its own columns).

    Raises:
        ValueError: an ndarray without 2 or 3 columns.
        TypeError: an input of another kind or file suffix.
    """
    if isinstance(input_table, LocationTable):
        return LocationTable({k: input_table[k].copy() for k in input_table.columns})
    if isinstance(input_table, (str, Path)):
        path = Path(input_table)
        if path.suffix == ".npy":
            input_table = np.load(str(path))
        elif path.suffix == ".csv":
            return _read_csv(path)
        elif path.suffix == ".json":
            with path.open() as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                return LocationTable({k: np.asarray(v) for k, v in data.items()})
            keys = list(dict.fromkeys(k for record in data for k in record))
            return LocationTable({k: np.asarray([r.get(k) for r in data]) for k in keys})
        else:
            msg = f"File type not supported: {path.suffix}"
            raise TypeError(msg)
    if isinstance(input_table, np.ndarray):
        if input_table.ndim == 2 and input_table.shape[1] in (2, 3):
            table = LocationTable({"x": input_table[:, 0], "y": input_table[:, 1]})
            table["class"] = (
                input_table[:, 2] if input_table.shape[1] == 3 else _none_column(len(input_table))
            )
            return table
        msg = "Numpy table should be of format `x, y` or `x, y, class`."
        raise ValueError(msg)
    msg = "File type not supported."
    raise TypeError(msg)


def write_probability_heatmap_as_ome_tiff(
    image_path,
    probability_map,
    colormap: int | None = None,
    tile_size: int = 256,
    mpp=None,
) -> Path:
    """Write a probability map as a pyramidal OME-TIFF heatmap (``misc.py:331-400``).

    Args:
        image_path: Output ``.ome.tiff`` path.
        probability_map: ``[H, W]`` float map in [0, 1] (or uint8).
        colormap: Optional OpenCV colormap id (``cv2.COLORMAP_JET`` is 2),
            applied from ``data/colormaps.npz`` as ``cv2.applyColorMap`` does;
            greyscale RGB when None.
        tile_size: Pyramid tile size.
        mpp: Optional (x, y) microns-per-pixel metadata.

    Each level halves the one above (sizes rounded down) by area averaging
    with the port's ``imresize``: bit for bit with ``cv2.INTER_AREA`` where
    the sizes are even, within one grey level where a size is odd.
    """
    from tiatoolbox_tpu_torch.utils.store_conversion import colour_tables
    from tiatoolbox_tpu_torch.utils.transforms import imresize
    from tiatoolbox_tpu_torch.wsicore.tiffio import TiffPyramidWriter

    prob = np.asarray(probability_map)
    if prob.dtype != np.uint8:
        prob = np.clip(prob * 255.0, 0, 255).astype(np.uint8)
    if colormap is not None:
        tables = colour_tables()
        if f"cv2_{int(colormap)}" not in tables:
            msg = f"Unknown OpenCV colormap id {colormap}."
            raise ValueError(msg)
        rgb = tables[f"cv2_{int(colormap)}"][prob]
    else:
        rgb = np.stack([prob] * 3, axis=-1)

    levels = [rgb]
    while max(levels[-1].shape[:2]) > tile_size:
        prev = levels[-1]
        size = (max(1, prev.shape[1] // 2), max(1, prev.shape[0] // 2))
        levels.append(imresize(prev, output_size=size, interpolation="area"))
    h, w = rgb.shape[:2]
    physical = ""
    if mpp is not None:
        mpp = np.broadcast_to(np.asarray(mpp, dtype=float), 2)
        physical = (
            f' PhysicalSizeX="{mpp[0]}" PhysicalSizeXUnit="µm"'
            f' PhysicalSizeY="{mpp[1]}" PhysicalSizeYUnit="µm"'
        )
    ome_xml = (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0" Name="probability_heatmap">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" Type="uint8" '
        f'SizeX="{w}" SizeY="{h}" SizeC="3" SizeZ="1" SizeT="1"'
        f"{physical}>"
        '<Channel ID="Channel:0:0" SamplesPerPixel="3"/>'
        "<TiffData/></Pixels></Image></OME>"
    )
    writer = TiffPyramidWriter(
        image_path,
        tile_size=tile_size,
        description=ome_xml,
        mpp=tuple(mpp) if mpp is not None else None,
        compression="deflate",
    )
    writer.write(levels)
    return Path(image_path)
