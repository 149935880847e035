"""Tile pyramid generation (counterpart of ``tiatoolbox_tpu/tools/pyramid.py``).

Deep-zoom and Zoomify tile access over a ``WSIReader``, and an annotation
tile generator that renders an ``AnnotationStore`` into tiles through
``AnnotationRenderer`` (JAX :21-242). ``dump`` writes every tile to a
directory (``imwrite``), a ``.zip`` or a ``.tar``; archive tiles are the
bytes of ``cv2.imencode(".jpg", bgr)`` from the port's JPEG encoder at
OpenCV's default quality 95, as JAX's are (:165).
"""

from __future__ import annotations

import tarfile
import time
import zipfile
from io import BytesIO
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import native
from tiatoolbox_tpu_torch.utils.misc import imwrite
from tiatoolbox_tpu_torch.utils.transforms import imresize, locsize2bounds


class TilePyramidGenerator:
    """Deep-zoom style tile pyramid over a WSIReader.

    Level 0 is the most zoomed out (single tile); the highest level is
    baseline resolution.

    Args:
        wsi: A WSIReader instance.
        tile_size: Output tile edge length (excluding overlap).
        downsample: Downsample factor between levels.
        overlap: Extra border pixels per tile edge.
    """

    def __init__(
        self,
        wsi,
        tile_size: int = 256,
        downsample: int = 2,
        overlap: int = 0,
    ) -> None:
        self.wsi = wsi
        self.tile_size = tile_size
        self.overlap = overlap
        self.downsample = downsample

    @property
    def output_tile_size(self) -> int:
        """Tile size including overlap borders."""
        return self.tile_size + 2 * self.overlap

    def level_downsample(self, level: int) -> float:
        """Downsample factor of a pyramid level (reference ``pyramid.py:80``)."""
        return float(2 ** (self.level_count - level - 1))

    @property
    def sub_tile_level_count(self) -> int:
        """Levels below one full tile (0 here; Zoomify overrides)."""
        return 0

    def get_thumb_tile(self) -> np.ndarray:
        """Whole-slide thumbnail with longest edge = tile size."""
        slide_dims = np.array(self.wsi.info.slide_dimensions)
        tile_dim = self.tile_size + self.overlap
        out_dims = np.round(
            slide_dims / slide_dims.max() * tile_dim
        ).astype(int)
        bounds = (0, 0, *slide_dims)
        thumb = self.wsi.read_bounds(bounds, resolution=0, units="level")
        return imresize(thumb, output_size=tuple(out_dims))

    @property
    def level_count(self) -> int:
        """Number of levels in the generated pyramid."""
        baseline = np.array(self.wsi.info.slide_dimensions)
        level_0_tiles = np.ceil(baseline / self.tile_size)
        return int(np.ceil(np.log2(level_0_tiles.max())) + 1)

    def level_dimensions(self, level: int) -> tuple[int, int]:
        """Pixel dimensions of a pyramid level."""
        baseline = np.array(self.wsi.info.slide_dimensions)
        scale = 2 ** (self.level_count - level - 1)
        return tuple(np.ceil(baseline / scale).astype(int))

    def tile_grid_size(self, level: int) -> tuple[int, int]:
        """Tile counts (across, down) of a level."""
        if level < 0 or level >= self.level_count:
            msg = "Invalid level."
            raise IndexError(msg)
        return tuple(
            np.ceil(np.divide(self.level_dimensions(level), self.tile_size)).astype(
                int
            )
        )

    def get_tile(
        self,
        level: int,
        x: int,
        y: int,
        res: int = 1,
        pad_mode: str = "constant",
        interpolation: str = "optimise",
    ) -> np.ndarray:
        """Render one tile (uint8 RGB HxW of output_tile_size)."""
        if level < 0 or level >= self.level_count:
            msg = "Invalid level."
            raise IndexError(msg)
        scale = 2 ** (self.level_count - level - 1)
        if x < 0 or y < 0:
            msg = "Tile coordinates must be non-negative."
            raise IndexError(msg)
        grid = self.tile_grid_size(level)
        if x >= grid[0] or y >= grid[1]:
            msg = "Tile coordinates out of range."
            raise IndexError(msg)
        baseline_tile = self.tile_size * scale
        location = (np.array([x, y]) * baseline_tile) - self.overlap * scale
        size = np.array([self.output_tile_size] * 2) * scale
        bounds = locsize2bounds(location, size)
        out_size = self.output_tile_size * res
        region = self.wsi.read_bounds(
            bounds,
            resolution=1 / scale,
            units="baseline",
            pad_mode=pad_mode,
            interpolation=interpolation,
        )
        if region.shape[0] != out_size or region.shape[1] != out_size:
            region = imresize(region, output_size=(out_size, out_size))
        return region

    def tile_path(self, level: int, x: int, y: int) -> Path:
        """Relative path of a tile in a dumped pyramid (deep-zoom style)."""
        return Path(str(level)) / f"{x}_{y}.jpg"

    def dump(self, path, container: str | None = None, compression=None) -> None:
        """Write all pyramid tiles to a directory, .zip, or .tar."""
        path = Path(path)
        if container == "zip":
            archive = zipfile.ZipFile(path, "w")
        elif container == "tar":
            archive = tarfile.open(path, "w")
        elif container is None:
            path.mkdir(parents=True, exist_ok=True)
            archive = None
        else:
            msg = f"Unsupported container: {container}"
            raise ValueError(msg)
        del compression
        for level in range(self.level_count):
            grid_w, grid_h = self.tile_grid_size(level)
            for y in range(grid_h):
                for x in range(grid_w):
                    tile = self.get_tile(level, x, y)
                    rel = self.tile_path(level, x, y)
                    if archive is None:
                        out = path / rel
                        out.parent.mkdir(parents=True, exist_ok=True)
                        imwrite(out, tile)
                    else:
                        # OpenCV's JPEG encoder drops the alpha of an RGBA tile
                        data = native.encode_jpeg(tile[..., :3] if tile.shape[-1] == 4 else tile, 95)
                        if isinstance(archive, zipfile.ZipFile):
                            archive.writestr(str(rel), data)
                        else:
                            info = tarfile.TarInfo(str(rel))
                            info.size = len(data)
                            info.mtime = int(time.time())
                            archive.addfile(info, BytesIO(data))
        if archive is not None:
            archive.close()


class ZoomifyGenerator(TilePyramidGenerator):
    """Zoomify tile path layout (TileGroup{N}/{z}-{x}-{y}.jpg)."""

    def tile_group(self, level: int, x: int, y: int) -> int:
        """Tile group index (tiles numbered in reading order, 256/group)."""
        grid = self.tile_grid_size(level)
        if x >= grid[0] or y >= grid[1]:
            msg = "Tile coordinates out of range."
            raise IndexError(msg)
        cumsum = 0
        for lvl in range(level):
            gw, gh = self.tile_grid_size(lvl)
            cumsum += gw * gh
        index_in_level = y * grid[0] + x
        tile_index = cumsum + index_in_level
        return tile_index // 256

    def tile_path(self, level: int, x: int, y: int) -> Path:
        group = self.tile_group(level, x, y)
        return Path(f"TileGroup{group}") / f"{level}-{x}-{y}.jpg"


class AnnotationTileGenerator(TilePyramidGenerator):
    """Render AnnotationStore contents into pyramid tiles.

    Args:
        info: WSIMeta of the base slide (defines coordinate space).
        store: AnnotationStore to render.
        renderer: AnnotationRenderer (default created if None).
    """

    def __init__(
        self,
        info,
        store,
        renderer=None,
        tile_size: int = 256,
        downsample: int = 2,
        overlap: int = 0,
    ) -> None:
        from tiatoolbox_tpu_torch.utils.visualization import AnnotationRenderer
        from tiatoolbox_tpu_torch.wsicore.wsireader import VirtualWSIReader

        blank = np.zeros((16, 16, 3), np.uint8)
        wsi = VirtualWSIReader(blank, info=info)
        super().__init__(wsi, tile_size, downsample, overlap)
        self.info = info
        self.store = store
        self.renderer = renderer if renderer is not None else AnnotationRenderer()

    def get_tile(self, level: int, x: int, y: int, **kwargs) -> np.ndarray:  # noqa: ARG002
        """Render annotations intersecting this tile to RGBA."""
        if level < 0 or level >= self.level_count:
            msg = "Invalid level."
            raise IndexError(msg)
        scale = 2 ** (self.level_count - level - 1)
        baseline_tile = self.tile_size * scale
        x0 = x * baseline_tile
        y0 = y * baseline_tile
        bounds = (x0, y0, x0 + baseline_tile, y0 + baseline_tile)
        return self.renderer.render_annotations(
            self.store, bounds, scale=scale, output_size=self.output_tile_size
        )
