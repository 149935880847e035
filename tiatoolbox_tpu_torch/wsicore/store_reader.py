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

``TransformedWSIReader`` (:116-245) reads a moving slide through a
registration transform, as JAX's does: a 3x3 affine through
``AffineWSITransformer``, or a displacement field sampled over the request
in the ``max(moving, fixed)`` frame with the moving slide centred
(:207-239) and remapped with border value 255; both warp through the
port's OpenCV-exact ``utils.warp``.

``AnnotationStoreReader`` (:24-113) renders an ``AnnotationStore`` as a
virtual slide through ``AnnotationRenderer``, alone (composited onto white)
or over a ``base_wsi`` with ``alpha``, resizing with the port's
OpenCV-exact bilinear ``imresize`` where JAX calls ``cv2.resize``.
"""

from __future__ import annotations

import base64
import json
import urllib.request
import zlib
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch.tools.registration.wsi_registration import AffineWSITransformer
from tiatoolbox_tpu_torch.utils.transforms import background_composite, imresize
from tiatoolbox_tpu_torch.utils.warp import remap_linear
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


class AnnotationStoreReader(WSIReader):
    """Render an ``AnnotationStore`` as a virtual slide (JAX :24-113).

    Args:
        store: ``AnnotationStore`` instance or path to a ``.db`` file.
        info: ``WSIMeta`` of the coordinate space (taken from ``base_wsi``
            when given; otherwise from the store's bounds).
        renderer: ``AnnotationRenderer`` (the default one when None).
        base_wsi: Optional slide (reader or path) under the annotations.
        alpha: Annotation opacity over the base slide.
    """

    def __init__(
        self,
        store,
        info: WSIMeta | None = None,
        renderer=None,
        base_wsi=None,
        alpha: float = 1.0,
        **kwargs,
    ) -> None:
        from tiatoolbox_tpu_torch.annotation.storage import AnnotationStore
        from tiatoolbox_tpu_torch.utils.visualization import AnnotationRenderer

        path = store if isinstance(store, (str, Path)) else None
        super().__init__(path if path is not None else np.zeros(1), **kwargs)
        self.store = AnnotationStore.open(store) if isinstance(store, (str, Path)) else store
        self.base_wsi = WSIReader.open(base_wsi) if base_wsi is not None else None
        self.renderer = renderer or AnnotationRenderer()
        self.alpha = alpha
        if info is not None:
            self._m_info = info
        elif self.base_wsi is not None:
            self._m_info = self.base_wsi.info

    def _info(self) -> WSIMeta:
        if self.base_wsi is not None:
            return self.base_wsi.info
        # the canvas reaches the store's farthest bound
        bounds_list = list(self.store.bquery((-1e300, -1e300, 1e300, 1e300)).values())
        if bounds_list:
            arr = np.array(bounds_list)
            w = int(np.ceil(arr[:, 2].max()))
            h = int(np.ceil(arr[:, 3].max()))
        else:
            w = h = 1024
        return WSIMeta(
            slide_dimensions=(w, h),
            axes="YXS",
            level_dimensions=[(w, h)],
            level_downsamples=[1.0],
            vendor="annotation-store",
            raw=None,
        )

    def _read_level_within(self, location, size, level: int) -> np.ndarray:
        ds = self.info.level_downsamples[level]
        x0 = location[0] * ds
        y0 = location[1] * ds
        w = size[0] * ds
        h = size[1] * ds
        rendered = self.renderer.render_annotations(
            self.store,
            (x0, y0, x0 + w, y0 + h),
            scale=ds,
            output_size=int(size[0]),
        )
        if rendered.shape[0] != size[1] or rendered.shape[1] != size[0]:
            rendered = imresize(rendered, output_size=(int(size[0]), int(size[1])), interpolation="linear")
        if self.base_wsi is not None:
            base = self.base_wsi.read_bounds(
                (int(x0), int(y0), int(x0 + w), int(y0 + h)),
                resolution=1 / ds,
                units="baseline",
            )
            if base.shape[:2] != rendered.shape[:2]:
                base = imresize(base, output_size=rendered.shape[1::-1], interpolation="linear")
            alpha_map = (rendered[..., 3:4].astype(float) / 255.0) * self.alpha
            blended = base.astype(float) * (1 - alpha_map) + rendered[..., :3].astype(float) * alpha_map
            return np.clip(blended, 0, 255).astype(np.uint8)
        return background_composite(rendered, alpha=False)


class TransformedWSIReader(WSIReader):
    """Read a (moving) slide through a registration transform (JAX :116-245).

    Args:
        reader: The moving-slide reader (or path).
        transform: 3x3 affine at baseline, or dense displacement field
            [H, W, 2] in a downsampled frame (auto-scaled).
        fixed_info: WSIMeta of the fixed frame (defaults to moving's).
    """

    def __init__(self, reader, transform, fixed_info=None, **kwargs) -> None:
        reader = WSIReader.open(reader)
        super().__init__(reader.input_path or np.zeros(1), **kwargs)
        self.reader = reader
        transform = np.asarray(transform, dtype=float)
        if transform.shape == (3, 3):
            self._affine = AffineWSITransformer(reader, transform)
            self._field = None
        else:
            self._affine = None
            self._field = transform
        self._m_info = fixed_info if fixed_info is not None else reader.info

    def _info(self) -> WSIMeta:
        # Reads are addressed in the FIXED frame (the transform maps fixed
        # coords onto the moving slide), so the reported geometry is the
        # fixed frame's. Defaults to the moving slide's info.
        return self._m_info

    @staticmethod
    def transform_points(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
        """Warp (N, 2) points through a 3x3 transform (reference :7052)."""
        points = np.asarray(points, dtype=float)
        padded = np.hstack([points, np.ones((points.shape[0], 1))])
        return (padded @ np.asarray(transform).T)[:, :-1]

    @staticmethod
    def get_patch_dimensions(size: tuple[int, int], transform: np.ndarray) -> tuple[int, int]:
        """Max source patch size covering an output patch (reference :7072).

        Translation is removed; for an affine map the extrema lie at the
        output rectangle's corners.
        """
        w, h = int(size[0]), int(size[1])
        t = np.asarray(transform, dtype=float) * np.array([[1, 1, 0], [1, 1, 0], [1, 1, 1]])
        corners = np.array([[0, 0], [w, 0], [0, h], [w, h]], dtype=float)
        warped = TransformedWSIReader.transform_points(corners, t)
        span = warped.max(axis=0) - warped.min(axis=0)
        return (int(np.ceil(span[0])), int(np.ceil(span[1])))

    def get_transformed_location(
        self, location: tuple[int, int], size: tuple[int, int]
    ) -> tuple[tuple[int, int], tuple[int, int]]:
        """Map an output-frame read onto the moving slide (reference :7126).

        Returns the moving-frame top-left and the patch size needed to
        cover the transformed rectangle.
        """
        if self._affine is None:
            msg = "get_transformed_location requires an affine transform."
            raise ValueError(msg)
        inv = np.linalg.inv(self._affine.transform_level0)
        corners = np.array(
            [
                [location[0], location[1]],
                [location[0] + size[0], location[1]],
                [location[0], location[1] + size[1]],
                [location[0] + size[0], location[1] + size[1]],
            ],
            dtype=float,
        )
        warped = self.transform_points(corners, inv)
        tl = warped.min(axis=0)
        span = warped.max(axis=0) - tl
        return (
            (int(np.floor(tl[0])), int(np.floor(tl[1]))),
            (int(np.ceil(span[0])), int(np.ceil(span[1]))),
        )

    def _read_level_within(self, location, size, level: int) -> np.ndarray:
        ds = self.info.level_downsamples[level]
        loc0 = (int(location[0] * ds), int(location[1] * ds))
        size0 = (int(size[0] * ds), int(size[1] * ds))
        if self._affine is not None:
            region = self._affine.read_rect(loc0, size0)
        else:
            field = self._field
            fh, fw = field.shape[:2]
            # Reference scaling (wsireader.py:6934-6948): the field frame
            # is max(moving, fixed) dims per axis, with the moving slide
            # centered via (fixed - moving)//2 pads when sizes differ.
            base_w, base_h = self.info.slide_dimensions
            mov_w, mov_h = self.reader.info.slide_dimensions
            frame_w, frame_h = max(base_w, mov_w), max(base_h, mov_h)
            pad_x, pad_y = (base_w - mov_w) // 2, (base_h - mov_h) // 2
            sx, sy = fw / frame_w, fh / frame_h
            # sample the displacement field over the requested region
            xs = (np.arange(size0[0]) + loc0[0]) * sx
            ys = (np.arange(size0[1]) + loc0[1]) * sy
            xi = np.clip(xs.astype(int), 0, fw - 1)
            yi = np.clip(ys.astype(int), 0, fh - 1)
            disp = field[np.ix_(yi, xi)]
            src_x = (xs[None, :] / sx + disp[..., 0] / sx - pad_x).astype(np.float32)
            src_y = (ys[:, None] / sy + disp[..., 1] / sy - pad_y).astype(np.float32)
            x0, x1 = int(src_x.min()) - 2, int(src_x.max()) + 2
            y0, y1 = int(src_y.min()) - 2, int(src_y.max()) + 2
            region0 = self.reader.read_bounds((x0, y0, x1, y1), resolution=0, units="level")
            region = remap_linear(region0, src_x - x0, src_y - y0, border_value=255)
        if ds != 1:
            region = imresize(region, output_size=(int(size[0]), int(size[1])))
        return region


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
