"""A kerchunk (fsspec) reference JSON for a tiled TIFF (counterpart of ``tiatoolbox_tpu/utils/tiff_to_fsspec.py:1-76``).

Each TIFF tile becomes a zarr chunk referenced as ``[url, offset, length]``,
so the slide can be read where it is served, without a download
(``wsicore/store_reader.py::FsspecJsonWSIReader``). Raw and deflate tiles
map onto zarr codecs directly; JPEG tiles are refused (read those with the
TIFF reader). Copied, on the port's ``tiffio``.
"""

from __future__ import annotations

import json
from pathlib import Path

from tiatoolbox_tpu_torch.wsicore.tiffio import (
    COMPRESSION_DEFLATE,
    COMPRESSION_DEFLATE_ADOBE,
    COMPRESSION_NONE,
    TiffFile,
)


def tiff_to_fsspec(
    tiff_path: str | Path,
    url: str,
    out_path: str | Path | None = None,
) -> dict:
    """Build (and optionally write) a reference JSON for a tiled TIFF.

    Args:
        tiff_path: Local TIFF to index.
        url: URL where the same bytes will be served.
        out_path: Optional path to write the reference JSON.

    Returns:
        The fsspec reference dict ({"version": 1, "refs": {...}}).
    """
    tiff = TiffFile(tiff_path)
    refs: dict = {}
    supported = (COMPRESSION_NONE, COMPRESSION_DEFLATE, COMPRESSION_DEFLATE_ADOBE)
    for level_idx, page_index in enumerate(tiff.pyramid_pages()):
        page = tiff.pages[page_index]
        if not page.is_tiled:
            msg = "Only tiled TIFFs can be converted to fsspec references."
            raise ValueError(msg)
        if page.compression not in supported:
            msg = (
                f"Unsupported compression {page.compression} for fsspec "
                "conversion (raw/deflate only; JPEG needs a JPEG numcodec)."
            )
            raise ValueError(msg)
        compressor = (
            None if page.compression == COMPRESSION_NONE else {"id": "zlib"}
        )
        zarray = {
            "zarr_format": 2,
            "shape": [page.height, page.width, page.samples_per_pixel],
            "chunks": [page.tile_length, page.tile_width, page.samples_per_pixel],
            "dtype": page.dtype.str,
            "compressor": compressor,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        prefix = str(level_idx)
        refs[f"{prefix}/.zarray"] = json.dumps(zarray)
        tiles_across = page.tiles_across
        for idx, (offset, count) in enumerate(zip(page.offsets, page.byte_counts)):
            ty, tx = divmod(idx, tiles_across)
            refs[f"{prefix}/{ty}.{tx}.0"] = [url, int(offset), int(count)]
    reference = {"version": 1, "refs": refs}
    if out_path is not None:
        Path(out_path).write_text(json.dumps(reference))
    tiff.close()
    return reference
