"""Readers layered on other stores (counterpart of ``tiatoolbox_tpu/wsicore/store_reader.py``).

``FsspecJsonWSIReader`` (:250-320) reads a slide through a kerchunk
reference JSON: zarr chunks that are byte ranges of a file served locally
or over HTTP(S). JAX resolves the references through ``fsspec``; the card
machine has no fsspec, so ``ReferenceMapper`` resolves them itself:

- inline values (text, or ``base64:`` bytes);
- ``[url]`` (the whole file) and ``[url, offset, length]`` (a byte range),
  where ``url`` is a local path, a ``file://`` URL, or an ``http://`` /
  ``https://`` URL fetched with ``urllib.request`` and a ``Range`` header,

in a version 1 document (``{"version": 1, "refs": {...}}``), as
``tiff_to_fsspec`` writes it.

``AnnotationStoreReader`` and ``TransformedWSIReader`` are not ported yet
(``ROADMAP.md`` section 1 items 4 and 6).
"""

from __future__ import annotations

import base64
import json
import urllib.request
import zlib
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch.wsicore.wsimeta import WSIMeta
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader


class ReferenceMapper:
    """Key -> bytes over a kerchunk reference document.

    Args:
        reference: The parsed reference JSON.
        timeout: Seconds an HTTP request may take.
    """

    def __init__(self, reference: dict, timeout: float = 60.0) -> None:
        self._refs = dict(reference["refs"])
        self._timeout = timeout

    def __iter__(self):
        return iter(self._refs)

    def __contains__(self, key: str) -> bool:
        return key in self._refs

    def __getitem__(self, key: str) -> bytes:
        value = self._refs[key]
        if isinstance(value, str):
            if value.startswith("base64:"):
                return base64.b64decode(value[len("base64:") :])
            return value.encode()
        if isinstance(value, (bytes, bytearray)):
            return bytes(value)
        if not isinstance(value, list) or len(value) not in (1, 3):
            msg = f"Reference {key!r} is neither inline data, [url] nor [url, offset, length]."
            raise ValueError(msg)
        url = value[0]
        offset, length = (int(value[1]), int(value[2])) if len(value) == 3 else (0, None)
        return self._fetch(url, offset, length)

    def _fetch(self, url: str, offset: int, length: int | None) -> bytes:
        if url.startswith(("http://", "https://")):
            request = urllib.request.Request(url)  # noqa: S310 - the reference names it
            if length is not None:
                request.add_header("Range", f"bytes={offset}-{offset + length - 1}")
            with urllib.request.urlopen(request, timeout=self._timeout) as response:  # noqa: S310
                data = response.read()
            if length is not None and response.status == 200:
                # a server that ignores Range sends the whole file
                data = data[offset : offset + length]
            return data
        path = Path(url[len("file://") :] if url.startswith("file://") else url)
        with path.open("rb") as fh:
            fh.seek(offset)
            return fh.read() if length is None else fh.read(length)


class FsspecJsonWSIReader(WSIReader):
    """A zarr pyramid behind a kerchunk (fsspec) reference JSON (JAX :250-320)."""

    def __init__(self, input_img, mpp=None, power=None) -> None:
        super().__init__(input_img, mpp=mpp, power=power)
        with Path(input_img).open() as fh:
            reference = json.load(fh)
        self._mapper = ReferenceMapper(reference)
        self._levels = self._parse_levels()
        self._n_channels = 3

    def _parse_levels(self) -> list[dict]:
        levels = []
        for key in sorted(self._mapper):
            if key.endswith(".zarray"):
                meta = json.loads(self._mapper[key])
                prefix = key[: -len(".zarray")].rstrip("/")
                levels.append({"prefix": prefix, "meta": meta})
        levels.sort(key=lambda lv: -lv["meta"]["shape"][1])
        return levels

    def _info(self) -> WSIMeta:
        dims = [(lv["meta"]["shape"][1], lv["meta"]["shape"][0]) for lv in self._levels]
        base = dims[0]
        return WSIMeta(
            slide_dimensions=base,
            axes="YXS",
            level_dimensions=dims,
            level_downsamples=[base[0] / d[0] for d in dims],
            level_count=len(dims),
            vendor="fsspec",
            raw=None,
        )

    def _read_level_within(self, location, size, level: int) -> np.ndarray:
        lv = self._levels[level]
        meta = lv["meta"]
        chunks = meta["chunks"]
        dtype = np.dtype(meta["dtype"])
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        n_ch = meta["shape"][2] if len(meta["shape"]) > 2 else 1
        out = np.zeros((h, w, n_ch), dtype=dtype)
        for cy in range(y0 // chunks[0], (y0 + h - 1) // chunks[0] + 1):
            for cx in range(x0 // chunks[1], (x0 + w - 1) // chunks[1] + 1):
                key = f"{lv['prefix']}/{cy}.{cx}.0" if n_ch > 1 else f"{lv['prefix']}/{cy}.{cx}"
                if key not in self._mapper:
                    continue
                raw = self._mapper[key]
                if meta.get("compressor"):
                    raw = zlib.decompress(raw)
                chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks[0], chunks[1], n_ch)
                gy0, gx0 = cy * chunks[0], cx * chunks[1]
                sy0, sx0 = max(y0 - gy0, 0), max(x0 - gx0, 0)
                sy1 = min(y0 + h - gy0, chunks[0])
                sx1 = min(x0 + w - gx0, chunks[1])
                out[
                    gy0 + sy0 - y0 : gy0 + sy1 - y0,
                    gx0 + sx0 - x0 : gx0 + sx1 - x0,
                ] = chunk[sy0:sy1, sx0:sx1]
        return out
