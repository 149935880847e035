"""Host helpers (counterpart of the parts of ``tiatoolbox_tpu/utils/misc.py`` the port uses).

``get_luminosity_tissue_mask`` (:149) thresholds the L channel of OpenCV's
8-bit RGB->LAB conversion. ``lab_luminosity_u8`` reproduces that channel
without OpenCV, with OpenCV's own fixed-point tables (sRGB gamma table,
cube-root table, 12-bit luminance coefficients, 15-bit L descale): it
equals ``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)[..., 0]`` for every one of
the 2**24 RGB colours.

``rgb2lab_u8`` and ``lab2rgb_u8`` extend those tables to OpenCV's whole
8-bit ``COLOR_RGB2LAB`` and ``COLOR_LAB2RGB`` (the latter OpenCV's integer
path: L and a/b lookup tables, 14-bit fixed-point XYZ, a 4096-entry inverse
gamma table), for ``ReinhardNormalizer``; ``imread`` (:41-60) reads
``.npy``, PNG, JPEG and BMP through the port's own codecs
(``utils/imagecodec.py``), and ``imwrite`` (:66-76) writes JPEG through the
port's encoder (OpenCV's bytes) and PNG through ``zlib``.

``get_bounding_box`` (:165) is the box of a mask's nonzero pixels.

``read_locations`` (:193) reads point annotations from an ndarray, ``.npy``,
``.csv`` or ``.json`` into a ``LocationTable``, a small numpy-backed table
with the columns of JAX's DataFrame (the card machine has no pandas).

The file and data helpers are JAX's, copied (:24-40, :176-190, :244-330,
:401-586): ``split_path_name_ext``, ``grab_files_from_dir``,
``cast_to_min_dtype``, ``unzip_data`` (``zipfile``), ``save_yaml`` (the
port's YAML writer, ``utils/yaml_lite.py``: ``yaml.dump``'s text),
``save_as_json``, ``download_data`` (``urllib``), ``select_device``
(``"cuda"`` or ``"cpu"``), ``string_to_tuple``, ``ppu2mpp``,
``get_zarr_array`` (on ``zarrlite``), and the HoVer-Net ``.dat`` helpers
``make_valid_poly``, ``anns_from_hoverdict``, ``make_default_dict``,
``add_from_dat``, ``store_from_dat``, ``save_annotations`` and
``save_qupath_json``. JAX reads a ``.dat`` with ``joblib.load``; the port
reads the same uncompressed joblib stream (a pickle whose arrays follow
their ``NumpyArrayWrapper`` as raw bytes) with ``pickle``, and a plain
pickle too. ``load_stain_matrix`` is re-exported from
``tools/stainnorm.py``.
"""

from __future__ import annotations

import csv
import json
import pickle
import struct
import zipfile
import zlib
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.utils.exceptions import FileNotSupportedError
from tiatoolbox_tpu_torch.utils.imagecodec import PNG_SIGNATURE, imdecode

# mpp of a 40x objective; power <-> mpp as 10 / x (``misc.py:97-122``).
_COMMON_POWERS = (1, 1.25, 2, 2.5, 4, 5, 10, 20, 40, 60, 90, 100)


def imread(image_path, as_uint8: bool = True) -> np.ndarray:
    """Read an image file to an RGB(A) numpy array (JAX ``misc.py:41-60``).

    ``.npy`` arrays load as they are; PNG, JPEG, JPEG 2000 and BMP files decode through
    the port's codecs (``utils/imagecodec.py``) as ``cv2.imread(path,
    IMREAD_UNCHANGED)`` would, in RGB(A) order. With ``as_uint8`` a
    non-uint8 image is clipped to 0..255 and cast, as JAX does.

    Raises:
        FileNotFoundError: no such file.
        FileNotSupportedError: a file the port cannot decode.
    """
    image_path = Path(image_path)
    if not image_path.is_file():
        msg = f"Could not find image file: {image_path}"
        raise FileNotFoundError(msg)
    if image_path.suffix == ".npy":
        image = np.load(str(image_path))
    else:
        image = imdecode(image_path.read_bytes(), "unchanged")
        if image is None:
            msg = f"Unable to decode image: {image_path}"
            raise FileNotSupportedError(msg)
    if as_uint8 and image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    return image


def _png_bytes(img: np.ndarray) -> bytes:
    """A PNG stream of a grey, grey+alpha, RGB or RGBA uint8 image: one IDAT,
    filter 0 on every row, zlib at its default level."""
    if img.dtype != np.uint8:
        msg = f"the port writes PNG of uint8 samples, got {img.dtype}."
        raise FileNotSupportedError(msg)
    arr = img if img.ndim == 3 else img[:, :, None]
    h, w, cn = arr.shape
    colour_type = {1: 0, 2: 4, 3: 2, 4: 6}.get(cn)
    if colour_type is None:
        msg = f"PNG holds 1 to 4 channels, got {cn}."
        raise FileNotSupportedError(msg)
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    return PNG_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def imwrite(image_path, img: np.ndarray) -> None:
    """Write an RGB(A) or grey numpy array to an image file (JAX ``misc.py:66-76``).

    ``.jpg``/``.jpeg`` go through the port's JPEG encoder at OpenCV's default
    quality 95: the bytes ``cv2.imwrite`` writes (an alpha channel is
    dropped, as OpenCV drops it). ``.png`` (uint8) is written with ``zlib``;
    its pixels read back as written, its bytes are not OpenCV's.

    Raises:
        FileNotSupportedError: another suffix, or samples other than uint8.
    """
    from tiatoolbox_tpu_torch import native

    image_path = Path(image_path)
    img = np.asarray(img)
    suffix = image_path.suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        if img.dtype != np.uint8:
            msg = f"JPEG holds uint8 samples, got {img.dtype}."
            raise FileNotSupportedError(msg)
        data = native.encode_jpeg(img[..., :3] if img.ndim == 3 and img.shape[2] == 4 else img, 95)
    elif suffix == ".png":
        data = _png_bytes(img)
    else:
        msg = f"imwrite writes .jpg, .jpeg and .png in the port, not {image_path.suffix!r}: {image_path}"
        raise FileNotSupportedError(msg)
    image_path.write_bytes(data)


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
    # the cube-root table in float32, as OpenCV's softfloat builds it (in
    # float64, 3 of its 3072 entries round the other way)
    f32 = np.float32
    x = f32(1) / f32(255 * 8) * np.arange(256 * 3 // 2 * 8).astype(f32)
    linear_part = (
        x.astype(np.float64) * float(f32(841) / f32(108)) + float(f32(16) / f32(116))
    ).astype(f32)
    cbrt = np.where(x < f32(216) / f32(24389), linear_part, np.cbrt(x))
    cbrt_tab = np.rint(f32(32768) * cbrt).astype(np.int64)
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


# sRGB -> XYZ (D65) and back, and the D65 white point, as OpenCV's color_lab.cpp has them
_SRGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169], [0.019334, 0.119193, 0.950227]]
)
_XYZ2SRGB = np.array(
    [[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556], [0.055648, -0.204043, 1.057311]]
)
_D65 = np.array([0.950456, 1.0, 1.088754])
# RGB -> XYZ over the white point, in 12-bit fixed point (row Y is _Y_COEFS)
_LAB_COEFS = np.rint(4096 * _SRGB2XYZ / _D65[:, None]).astype(np.int64)


def rgb2lab_u8(img: np.ndarray) -> np.ndarray:
    """8-bit CIE LAB of a uint8 RGB image, bit-exact to OpenCV's ``COLOR_RGB2LAB``.

    L is scaled to 0..255 and a, b are offset by 128, as OpenCV stores them.
    """
    rgb = np.asarray(img, np.uint8)
    lin = [_GAMMA_TAB[rgb[..., k]] for k in range(3)]
    f_x, f_y, f_z = (
        _CBRT_TAB[(sum(lin[k] * int(row[k]) for k in range(3)) + (1 << 11)) >> 12]
        for row in _LAB_COEFS
    )
    lab = np.empty((*rgb.shape[:-1], 3), np.int64)
    lab[..., 0] = (296 * f_y - 1336934 + (1 << 14)) >> 15
    lab[..., 1] = (500 * (f_x - f_y) + (128 << 15) + (1 << 14)) >> 15
    lab[..., 2] = (200 * (f_y - f_z) + (128 << 15) + (1 << 14)) >> 15
    return np.clip(lab, 0, 255).astype(np.uint8)


_LAB_BASE = 1 << 14
_MIN_AB = -8145


def _inv_lab_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's ``initLabTabs`` tables of the 8-bit LAB -> RGB path.

    The float ones are computed in float32 as OpenCV's ``softfloat``
    does; the gamma curve in float64 with float32 constants.
    """
    f32 = np.float32
    base = f32(_LAB_BASE)
    ell = np.arange(256)
    low = ell <= 20
    y_low = np.rint((ell * _LAB_BASE * 20 * 9).astype(f32) / f32(17 * 29 * 29 * 29))
    ify_low = np.rint(base * (f32(16) / f32(116) + (ell * 5).astype(f32) / f32(3 * 17 * 29)))
    fy = (ell * 100 * _LAB_BASE).astype(f32) / f32(255 * 116) + f32(16 * _LAB_BASE) / f32(116)
    y_high = np.rint(fy * fy * fy / f32(_LAB_BASE * _LAB_BASE))
    y_tab = np.where(low, y_low, y_high).astype(np.int64)
    ify_tab = np.where(low, ify_low, np.rint(fy)).astype(np.int64)
    i = np.arange(_MIN_AB, _LAB_BASE * 9 // 4 + _MIN_AB, dtype=np.int64)
    # C integer division truncates toward zero
    lin_part = np.trunc(i * 108 / 841).astype(np.int64) - (_LAB_BASE * 16 // 116 * 108 // 841)
    cube_part = (i * i // _LAB_BASE) * i // _LAB_BASE
    xz_tab = np.where(i <= 3390, lin_part, cube_part)
    x = (np.arange(4096, dtype=f32) * (f32(1) / f32(4096))).astype(np.float64)
    threshold = float(f32(7827) / f32(2500000))
    low_scale = float(f32(55) / f32(1000))
    power = float(f32(12) / f32(5))
    gamma = np.where(
        x <= threshold,
        x * float(f32(1292) / f32(100)),
        (1.0 + low_scale) * np.power(x, 1.0 / power) - low_scale,
    ).astype(f32)
    inv_gamma_tab = np.rint(f32(255) * gamma).astype(np.int64)
    return y_tab, ify_tab, xz_tab, inv_gamma_tab


_Y_TAB, _IFY_TAB, _XZ_TAB, _INV_GAMMA_TAB = _inv_lab_tables()
# XYZ -> RGB times the white point, in 12-bit fixed point
_INV_LAB_COEFS = np.rint(4096 * _XYZ2SRGB * _D65[None, :]).astype(np.int64)


def lab2rgb_u8(img: np.ndarray) -> np.ndarray:
    """uint8 RGB of an 8-bit CIE LAB image, as OpenCV's ``COLOR_LAB2RGB`` computes it."""
    lab = np.asarray(img, np.uint8).astype(np.int64)
    ell, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    y = _Y_TAB[ell]
    ify = _IFY_TAB[ell]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _LAB_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _LAB_BASE // 200 + 1
    x = _XZ_TAB[ify + adiv - _MIN_AB]
    z = _XZ_TAB[ify - bdiv - _MIN_AB]
    out = np.empty((*lab.shape[:-1], 3), np.uint8)
    for k, (c0, c1, c2) in enumerate(_INV_LAB_COEFS):
        v = (c0 * x + c1 * y + c2 * z + (1 << 13)) >> 14
        out[..., k] = _INV_GAMMA_TAB[np.clip(v, 0, 4095)]
    return out


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
    with the port's ``imresize``: bit for bit with ``cv2.INTER_AREA``, odd
    sizes included.
    """
    from tiatoolbox_tpu_torch.utils.transforms import imresize
    from tiatoolbox_tpu_torch.utils.visualization import apply_color_map
    from tiatoolbox_tpu_torch.wsicore.tiffio import TiffPyramidWriter

    prob = np.asarray(probability_map)
    if prob.dtype != np.uint8:
        prob = np.clip(prob * 255.0, 0, 255).astype(np.uint8)
    if colormap is not None:
        rgb = apply_color_map(prob, colormap)
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


def __getattr__(name: str):
    """``load_stain_matrix`` lives in ``tools/stainnorm.py``, which imports this module."""
    if name == "load_stain_matrix":
        from tiatoolbox_tpu_torch.tools.stainnorm import load_stain_matrix

        return load_stain_matrix
    msg = f"module {__name__!r} has no attribute {name!r}"
    raise AttributeError(msg)


def split_path_name_ext(full_path) -> tuple[Path, str, list[str]]:
    """Split a path into directory, basename, and list of suffixes."""
    input_path = Path(full_path)
    return input_path.parent.absolute(), input_path.name, input_path.suffixes


def grab_files_from_dir(input_path, file_types=("*.jpg", "*.png", "*.tif")) -> list:
    """List files in a directory matching the given glob patterns."""
    input_path = Path(input_path)
    if isinstance(file_types, str):
        file_types = tuple(file_types.split(","))
    files_grabbed: list[Path] = []
    for files in file_types:
        files_grabbed.extend(input_path.glob(str(files)))
    return list(files_grabbed)


def cast_to_min_dtype(array: np.ndarray) -> np.ndarray:
    """Cast an integer array to the smallest dtype that holds its range."""
    if array.size == 0:
        return array
    lo, hi = array.min(), array.max()
    for dtype in (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32):
        info = np.iinfo(dtype)
        if info.min <= lo and hi <= info.max:
            return array.astype(dtype)
    return array


def unzip_data(zip_path, save_path, *, del_zip: bool = True) -> None:
    """Extract a zip archive to a directory."""
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(path=save_path)
    if del_zip:
        Path(zip_path).unlink()


def save_yaml(input_dict: dict, output_path="output.yaml", *, parents: bool = False, exist_ok: bool = False) -> None:
    """Write a dict to a YAML file: the text ``yaml.dump`` writes (``utils/yaml_lite.py``)."""
    from tiatoolbox_tpu_torch.utils import yaml_lite

    path = Path(output_path)
    if parents:
        path.parent.mkdir(parents=True, exist_ok=True)
    if not exist_ok and path.exists():
        msg = "File already exists."
        raise FileExistsError(msg)
    text = yaml_lite.dump(input_dict)
    with path.open("w") as fh:
        fh.write(text)


def save_as_json(data: dict | list, save_path, *, parents: bool = False, exist_ok: bool = False) -> None:
    """Write JSON-safe data to a file, converting numpy scalars/arrays."""

    def walk(obj):
        if isinstance(obj, dict):
            return {(k.item() if isinstance(k, np.generic) else k): walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [walk(v) for v in obj]
        if isinstance(obj, np.ndarray):
            return walk(obj.tolist())
        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, Path):
            return str(obj)
        return obj

    path = Path(save_path)
    if parents:
        path.parent.mkdir(parents=True, exist_ok=True)
    if not exist_ok and path.exists():
        msg = "File already exists."
        raise FileExistsError(msg)
    with path.open("w") as fh:
        json.dump(walk(data), fh)


def download_data(url: str, save_path, *, overwrite: bool = False) -> Path:
    """Download a file from a URL (no-op if cached and not overwrite).

    A failed download raises ``ConnectionError`` naming the URL.
    """
    save_path = Path(save_path)
    if save_path.exists() and not overwrite:
        return save_path
    save_path.parent.mkdir(parents=True, exist_ok=True)
    import urllib.request

    try:
        urllib.request.urlretrieve(url, str(save_path))  # noqa: S310
    except Exception as exc:
        msg = f"Could not download {url}: {exc}"
        raise ConnectionError(msg) from exc
    return save_path


def select_device(*, on_gpu: bool | None = None) -> str:
    """``"cpu"`` when ``on_gpu`` is False, ``"cuda"`` when it is True, else
    ``rcParam["device"]``.

    The answer goes through ``resolve_device``, so asking for the card where
    there is none raises instead of falling back to the CPU. JAX's returns
    its platform name (``"tpu"``, ``"gpu"`` or ``"cpu"``).
    """
    from tiatoolbox_tpu_torch import resolve_device

    if on_gpu is False:
        return "cpu"
    return str(resolve_device("cuda" if on_gpu else None))


def string_to_tuple(in_str: str) -> tuple[str, ...]:
    """Split a comma separated string into a tuple of strings."""
    return tuple(substring.strip() for substring in in_str.split(","))


def ppu2mpp(ppu: float, units: str | int) -> float:
    """Pixels-per-unit to microns-per-pixel.

    Args:
        ppu: Pixels per unit.
        units: "m"/"cm"/"mm"/"inch" or TIFF ResolutionUnit codes
            2 (inch) / 3 (cm).
    """
    microns_per_unit = {
        "meter": 1e6,
        "m": 1e6,
        "centimeter": 1e4,
        "cm": 1e4,
        "mm": 1e3,
        "inch": 25400,
        "in": 25400,
        2: 25400,
        3: 1e4,
    }
    if units not in microns_per_unit:
        msg = f"Invalid units: {units}"
        raise ValueError(msg)
    return 1 / ppu * microns_per_unit[units]


def get_zarr_array(zarr_array) -> np.ndarray:
    """Materialise a zarr-backed / array-like object as a numpy array."""
    from tiatoolbox_tpu_torch.utils.zarrlite import ZarrArray

    if isinstance(zarr_array, ZarrArray):
        return zarr_array[:]
    return np.array(zarr_array).astype(float)


def make_valid_poly(poly, origin: tuple[float, float] | None = None):
    """Translate to ``origin`` and repair degenerate polygons.

    Validity means at least 3 distinct points and nonzero ring area; an
    invalid polygon is fixed with a small buffer.
    """
    from tiatoolbox_tpu_torch.annotation.geometry import Polygon

    if origin is not None and tuple(origin) != (0, 0):
        shift = np.asarray(origin, dtype=float)
        if isinstance(poly, Polygon):
            poly = Polygon(poly.shell - shift, [h - shift for h in poly.holes])
        else:
            poly = type(poly)(poly.coords - shift)
    if isinstance(poly, Polygon):
        distinct = np.unique(poly.shell[:-1], axis=0)
        if len(distinct) < 3 or poly.area == 0:
            logger.warning("Invalid geometry found, fix using buffer().")
            return poly.buffer(0.01)
    return poly


def anns_from_hoverdict(data: dict, props: list, typedict: dict | None, origin: tuple[float, float], scale_factor) -> list:
    """HoVer-Net-style detection dict to an ``Annotation`` list."""
    from tiatoolbox_tpu_torch.annotation.geometry import geojson_to_geometry
    from tiatoolbox_tpu_torch.annotation.storage import Annotation

    annotations = []
    for ann in data.values():
        geom = geojson_to_geometry(
            {
                "type": ann.get("geom_type", "Polygon"),
                "coordinates": (np.asarray(scale_factor) * np.array([ann["contour"]])).tolist(),
            }
        )
        properties = {
            prop: (typedict[ann[prop]] if prop == "type" and typedict is not None else ann[prop])
            for prop in props[3:]
            if prop in ann
        }
        annotations.append(Annotation(make_valid_poly(geom, origin), properties))
    return annotations


def make_default_dict(data: dict, subcat: str) -> dict:
    """Auto type-name dict for one head of a multi-head ``.dat``."""
    types = {data[subcat][ann_id]["type"] for ann_id in data[subcat] if "type" in data[subcat][ann_id]}
    num_chars = min(3, len(subcat))
    return {t: f"{subcat[:num_chars]}: {t}" for t in types}


class _JoblibArray:
    """Stand-in for ``joblib.numpy_pickle.NumpyArrayWrapper``: the raw array follows it."""

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def read(self, fh) -> np.ndarray:
        count = int(np.prod(self.shape, dtype=np.int64)) if len(self.shape) else 1
        if self.dtype.hasobject:
            return pickle.load(fh)  # noqa: S301 - the .dat file is the caller's
        if self.__dict__.get("numpy_array_alignment_bytes") is not None:
            padding = int.from_bytes(fh.read(1), byteorder="little")
            fh.read(padding)
        data = fh.read(count * self.dtype.itemsize)
        if len(data) != count * self.dtype.itemsize:
            msg = "the .dat file ends inside an array."
            raise FileNotSupportedError(msg)
        array = np.frombuffer(data, dtype=self.dtype, count=count).copy()
        if self.order == "F":
            return array.reshape(self.shape[::-1]).transpose()
        return array.reshape(self.shape)


class _DatUnpickler(pickle._Unpickler):  # noqa: SLF001 - the pure-Python unpickler lets BUILD be overridden
    """Reads a plain pickle, or an uncompressed joblib stream, as ``joblib.load`` does."""

    dispatch = pickle._Unpickler.dispatch.copy()  # noqa: SLF001

    def __init__(self, fh) -> None:
        super().__init__(fh)
        self.file_handle = fh

    def find_class(self, module: str, name: str):
        if module == "joblib.numpy_pickle" and name == "NumpyArrayWrapper":
            return _JoblibArray
        if module.startswith("joblib"):
            msg = f"the port reads joblib's NumpyArrayWrapper only, not {module}.{name}."
            raise FileNotSupportedError(msg)
        return super().find_class(module, name)

    def load_build(self) -> None:
        pickle._Unpickler.load_build(self)  # noqa: SLF001
        if isinstance(self.stack[-1], _JoblibArray):
            self.stack.append(self.stack.pop().read(self.file_handle))

    dispatch[pickle.BUILD[0]] = load_build


_COMPRESSED_MAGIC = {b"\x78": "zlib", b"Z": "zlib", b"\x1f": "gzip", b"B": "bz2", b"\xfd": "xz", b"\x5d": "lzma",
                     b"\x04": "lz4"}  # a pickle starts with b"\x80" (protocol 2+) or an opcode


def _load_dat(fp) -> dict:
    """The dict of a ``.dat`` file: a pickle, or joblib's uncompressed stream."""
    with Path(fp).open("rb") as fh:
        head = fh.read(1)
        if head in _COMPRESSED_MAGIC:
            msg = f"compressed joblib files ({_COMPRESSED_MAGIC[head]}) are not read by the port: {fp}"
            raise FileNotSupportedError(msg)
        fh.seek(0)
        return _DatUnpickler(fh).load()


def add_from_dat(store, fp, scale_factor=(1, 1), typedict: dict | None = None, origin: tuple[float, float] = (0, 0)) -> None:
    """Load a HoVer-Net/cerberus ``.dat`` detection file into a store.

    A dict of instances (or category -> instances for multi-head cerberus
    output); the scale factor is inferred from stored base/proc resolutions
    when present.
    """
    data = _load_dat(fp)
    props = list(data[next(iter(data.keys()))].keys())
    if "base_resolution" in data and "proc_resolution" in data:
        scale_factor = data["proc_resolution"]["resolution"] / data["base_resolution"]["resolution"]
        logger.info("Scale factor inferred from resolutions: %s", scale_factor)
    if "contour" not in props:
        # cerberus format: objects subdivided into categories
        anns = []
        for subcat in data:
            if subcat in {"resolution", "proc_dimensions", "base_dimensions"} or "resolution" in subcat:
                continue
            sub_props = next(iter(data[subcat].values()))
            if not isinstance(sub_props, dict):
                continue
            sub_props = list(sub_props.keys())
            typedict_sub = make_default_dict(data, subcat) if typedict is None else typedict[subcat]
            anns.extend(anns_from_hoverdict(data[subcat], sub_props, typedict_sub, origin, scale_factor))
    else:
        anns = anns_from_hoverdict(data, props, typedict, origin, scale_factor)
    logger.info("Added %d annotations.", len(anns))
    store.append_many(anns)


def store_from_dat(fp, scale_factor=(1, 1), typedict: dict | None = None, origin: tuple[float, float] = (0, 0), cls=None):
    """New annotation store populated from a ``.dat`` detection file."""
    from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore

    store = (cls or SQLiteStore)()
    add_from_dat(store, fp, scale_factor, typedict=typedict, origin=origin)
    return store


def save_annotations(save_path: Path, store) -> Path:
    """Persist a store to ``save_path`` (forced ``.db`` extension)."""
    save_path = Path(save_path).with_suffix(".db")
    store.dump(str(save_path))
    return save_path


def save_qupath_json(save_path: Path, qupath_json: dict) -> Path:
    """Write a QuPath GeoJSON dict to ``save_path`` (forced ``.json``)."""
    save_path = Path(save_path).with_suffix(".json")
    with save_path.open("w") as fh:
        json.dump(qupath_json, fh, indent=2)
    return save_path
