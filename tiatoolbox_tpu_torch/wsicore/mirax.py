"""Native MIRAX (.mrxs) slide reader (counterpart of ``tiatoolbox_tpu/wsicore/mirax.py:1-274``).

The 3DHISTECH container as the JAX module parses it, copied: a
``<name>.mrxs`` stub beside a ``<name>/`` directory with ``Slidedat.ini``
(camera grid, zoom levels with their tile size, overlap, mpp and fill
colour, the data files), ``Index.dat`` (int32 page chains of ``(image_number,
offset, length, fileno)`` entries per level) and ``Data####.dat`` files of
camera tiles. Camera tile ``n`` sits at grid cell ``(n % IMAGENUMBER_X, n //
IMAGENUMBER_X)``; at zoom level ``L`` every ``2**L``-th cell carries a tile
and tiles step by ``tile - overlap`` level pixels, rounded where they land.

Tiles decode through the port's ``utils/imagecodec.py`` in its ``"color"``
mode (``cv2.IMREAD_COLOR``). A missing data file, a truncated payload or a
stream the decoder finds corrupt reads as the level's fill colour, as
OpenCV's ``None`` does in JAX; a stream the port's decoders do not support
(progressive or 12-bit JPEG, say) raises ``FileNotSupportedError``.
"""

from __future__ import annotations

import configparser
import struct
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch.utils.imagecodec import imdecode


class MiraxLevel:
    """One zoom level: geometry + tile index."""

    def __init__(
        self,
        level: int,
        tile_wh: tuple[int, int],
        overlap_xy: tuple[float, float],
        mpp_xy: tuple[float, float] | None,
        image_format: str,
        fill_bgr: int,
    ) -> None:
        self.level = level
        self.tile_wh = tile_wh
        self.overlap_xy = overlap_xy
        self.mpp_xy = mpp_xy
        self.image_format = image_format
        self.fill_bgr = fill_bgr
        # (tx, ty) -> (fileno, offset, length)
        self.tiles: dict[tuple[int, int], tuple[int, int, int]] = {}


class MiraxFile:
    """Parsed MIRAX container (Slidedat.ini + Index.dat + Data files)."""

    def __init__(self, path: str | Path) -> None:
        path = Path(path)
        self.mrxs_path = path
        self.data_dir = path.parent / path.stem
        if not self.data_dir.is_dir():
            msg = f"MIRAX data directory not found: {self.data_dir}"
            raise FileNotFoundError(msg)
        ini_path = self.data_dir / "Slidedat.ini"
        if not ini_path.exists():
            msg = f"Slidedat.ini not found in {self.data_dir}"
            raise FileNotFoundError(msg)
        self._parse_slidedat(ini_path)
        self._parse_index()

    # -- Slidedat.ini -------------------------------------------------------------

    def _parse_slidedat(self, ini_path: Path) -> None:
        parser = configparser.ConfigParser()
        parser.read_string(ini_path.read_text(encoding="utf-8-sig"))
        # configparser lower-cases keys; sections keep their case.
        general = parser["GENERAL"]
        self.slide_id = general.get("slide_id", "")
        self.slide_version = general.get("slide_version", "")
        self.grid_nx = int(general["imagenumber_x"])
        self.grid_ny = int(general["imagenumber_y"])

        hier = parser["HIERARCHICAL"]
        self.index_file = hier.get("indexfile", "Index.dat")
        hier_count = int(hier.get("hier_count", 1))
        # locate the zoom-level hierarchy (name "Slide zoom level")
        self.zoom_hier = 0
        for i in range(hier_count):
            name = hier.get(f"hier_{i}_name", "")
            if "zoom" in name.lower():
                self.zoom_hier = i
                break
        self.hier_counts = [
            int(hier.get(f"hier_{i}_count", 0)) for i in range(hier_count)
        ]
        self.nonhier_count = int(hier.get("nonhier_count", 0))
        self.nonhier_counts = [
            int(hier.get(f"nonhier_{i}_count", 0)) for i in range(self.nonhier_count)
        ]

        datafile = parser["DATAFILE"]
        n_files = int(datafile["file_count"])
        self.data_files = [
            self.data_dir / datafile[f"file_{k}"] for k in range(n_files)
        ]

        self.levels: list[MiraxLevel] = []
        n_levels = self.hier_counts[self.zoom_hier]
        for lvl in range(n_levels):
            section_name = hier.get(f"hier_{self.zoom_hier}_val_{lvl}_section")
            section = parser[section_name]
            mpp = None
            if "micrometer_per_pixel_x" in section:
                mpp = (
                    float(section["micrometer_per_pixel_x"]),
                    float(section.get("micrometer_per_pixel_y",
                                      section["micrometer_per_pixel_x"])),
                )
            self.levels.append(
                MiraxLevel(
                    level=lvl,
                    tile_wh=(
                        int(section["digitizer_width"]),
                        int(section["digitizer_height"]),
                    ),
                    overlap_xy=(
                        float(section.get("overlap_x", 0)),
                        float(section.get("overlap_y", 0)),
                    ),
                    mpp_xy=mpp,
                    image_format=section.get("image_format", "JPEG").upper(),
                    fill_bgr=int(section.get("image_fill_color_bgr", 0xFFFFFF)),
                )
            )

    # -- Index.dat ---------------------------------------------------------------

    def _read_page_entries(self, data: bytes, page_ptr: int) -> list[tuple]:
        """Follow a page chain; return (image_number, offset, length, fileno)."""
        entries = []
        while page_ptr:
            count, next_ptr = struct.unpack_from("<ii", data, page_ptr)
            pos = page_ptr + 8
            for _ in range(count):
                entries.append(struct.unpack_from("<iiii", data, pos))
                pos += 16
            page_ptr = next_ptr
        return entries

    def _parse_index(self) -> None:
        data = (self.data_dir / self.index_file).read_bytes()
        version_len = len(self.slide_version.encode())
        id_len = len(self.slide_id.encode())
        root_pos = version_len + id_len
        hier_root, self._nonhier_root = struct.unpack_from("<ii", data, root_pos)
        # hierarchical root: one int32 page pointer per (hier, value)
        slot = sum(self.hier_counts[: self.zoom_hier])
        for lvl, level in enumerate(self.levels):
            (page_ptr,) = struct.unpack_from("<i", data, hier_root + 4 * (slot + lvl))
            step = 2**lvl
            for image_number, offset, length, fileno in self._read_page_entries(
                data, page_ptr
            ):
                gx = image_number % self.grid_nx
                gy = image_number // self.grid_nx
                level.tiles[(gx // step, gy // step)] = (fileno, offset, length)
        self._index_data = data

    def read_associated(self, nonhier_index: int, value: int = 0) -> bytes | None:
        """Payload bytes of a nonhierarchical entry (label/macro/thumbnail)."""
        data = self._index_data
        slot = sum(self.nonhier_counts[:nonhier_index]) + value
        (page_ptr,) = struct.unpack_from(
            "<i", data, self._nonhier_root + 4 * slot
        )
        entries = self._read_page_entries(data, page_ptr)
        if not entries:
            return None
        _, offset, length, fileno = entries[0]
        with self.data_files[fileno].open("rb") as fh:
            fh.seek(offset)
            return fh.read(length)

    # -- geometry -----------------------------------------------------------------

    def level_tile_grid(self, level: int) -> tuple[int, int]:
        step = 2**level
        return (-(-self.grid_nx // step), -(-self.grid_ny // step))

    def level_dimensions(self, level: int) -> tuple[int, int]:
        lv = self.levels[level]
        nx, ny = self.level_tile_grid(level)
        tw, th = lv.tile_wh
        ox, oy = lv.overlap_xy
        step_x = tw - ox
        step_y = th - oy
        return (
            int(round((nx - 1) * step_x + tw)),
            int(round((ny - 1) * step_y + th)),
        )

    def decode_tile(self, level: int, tx: int, ty: int) -> np.ndarray | None:
        """Decode one camera tile to RGB, or None if absent/unreadable.

        Tiles whose data file is missing, whose payload is truncated,
        or whose bitstream fails to decode read as fill colour (the
        container stays usable with partial data, as OpenSlide does).

        Raises:
            FileNotSupportedError: a tile in a format or with a feature
                the port's decoders do not support.
        """
        lv = self.levels[level]
        entry = lv.tiles.get((tx, ty))
        if entry is None:
            return None
        fileno, offset, length = entry
        try:
            with self.data_files[fileno].open("rb") as fh:
                fh.seek(offset)
                payload = fh.read(length)
        except (OSError, IndexError):
            return None
        return imdecode(payload, "color")

    def fill_rgb(self, level: int) -> tuple[int, int, int]:
        bgr = self.levels[level].fill_bgr
        return ((bgr >> 0) & 0xFF, (bgr >> 8) & 0xFF, (bgr >> 16) & 0xFF)

    def read_region(self, level: int, location_xy, size_wh) -> np.ndarray:
        """Read an RGB region in level coordinates (fill-color padded)."""
        lv = self.levels[level]
        x0, y0 = (int(v) for v in location_xy)
        w, h = (int(v) for v in size_wh)
        out = np.empty((h, w, 3), np.uint8)
        out[:] = self.fill_rgb(level)
        tw, th = lv.tile_wh
        step_x = tw - lv.overlap_xy[0]
        step_y = th - lv.overlap_xy[1]
        nx, ny = self.level_tile_grid(level)
        tx0 = max(int((x0 - tw) // step_x), 0)
        ty0 = max(int((y0 - th) // step_y), 0)
        tx1 = min(int((x0 + w) // step_x) + 1, nx - 1)
        ty1 = min(int((y0 + h) // step_y) + 1, ny - 1)
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                px = int(round(tx * step_x))
                py = int(round(ty * step_y))
                if px >= x0 + w or py >= y0 + h or px + tw <= x0 or py + th <= y0:
                    continue
                tile = self.decode_tile(level, tx, ty)
                if tile is None:
                    continue
                dx0, dy0 = max(px - x0, 0), max(py - y0, 0)
                sx0, sy0 = max(x0 - px, 0), max(y0 - py, 0)
                cw = min(px + tw, x0 + w) - max(px, x0)
                ch = min(py + th, y0 + h) - max(py, y0)
                out[dy0 : dy0 + ch, dx0 : dx0 + cw] = tile[
                    sy0 : sy0 + ch, sx0 : sx0 + cw
                ]
        return out
