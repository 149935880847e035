"""WSGI tile server (counterpart of ``tiatoolbox_tpu/visualization/tileserver.py``).

JAX's server, route for route (:39-1009), on the stdlib ``wsgiref``
server:

- ``/`` and ``/viewer`` (the page of ``visualization/viewer.py``);
- ``/tileserver/layers``, ``/tileserver/info/<layer>``;
- ``/tileserver/layer/<layer>/<session>/zoomify/TileGroup<g>/<z>-<x>-<y>.jpg``;
- ``/tileserver/tap_query/<layer>/<x>/<y>``;
- the session-scoped control API: ``session_id``/``reset``, ``slide``,
  ``annotations``/``overlay`` (a ``.npy``/``.mha`` registration transform
  re-reads the slide through the port's ``TransformedWSIReader``)/
  ``clear_overlays``, ``color_prop``, ``cmap``, ``secondary_cmap``,
  ``renderer/<prop>``, ``prop_names``, ``prop_values``, ``prop_range``,
  ``prop_stats``, ``commit``, ``channels``, ``enhance``, ``graph``,
  ``segment_on_box``, ``prompt_segment``, ``sessions``, ``healthcheck``
  and ``shutdown``.

Tiles come from the port's ``ZoomifyGenerator`` and
``AnnotationTileGenerator`` (``tools/pyramid.py``). JAX encodes them with
cv2 (:905-913); the port encodes RGB tiles with its own JPEG encoder at
quality 85 (``native.encode_jpeg``: cv2's bytes) and RGBA tiles with its
PNG writer (``utils/misc.py``: the same pixels, other bytes).

``segment_on_box`` runs the port's ``MultiTaskSegmentor`` at JAX's batch 4
on ``rcParam["device"]`` (the card, unless the caller sets it to the CPU)
over the box, read at the model's resolution and fed as a virtual
slide; ``prompt_segment`` runs the port's ``PromptSegmentor`` there. The
engine is built on the thread that serves the request, which is where its
side stream and pinned slots are made and used. The server is
single-threaded, as JAX's is.
"""

from __future__ import annotations

import json
import re
import threading
from pathlib import Path
from wsgiref.simple_server import WSGIServer, make_server

import numpy as np

from tiatoolbox_tpu_torch import logger


def region_ioconfig(ioconfig):
    """The registry ``ioconfig`` in baseline units, for a region already read at
    the model's resolution and run as a virtual slide (JAX ``tileserver.py:531-545``)."""
    from tiatoolbox_tpu_torch.models.engine.io_config import IOInstanceSegmentorConfig

    return IOInstanceSegmentorConfig(
        input_resolutions=[{"units": "baseline", "resolution": 1.0}],
        output_resolutions=[{"units": "baseline", "resolution": 1.0}],
        patch_input_shape=ioconfig.patch_input_shape,
        patch_output_shape=getattr(ioconfig, "patch_output_shape", ioconfig.patch_input_shape),
        stride_shape=ioconfig.stride_shape,
        margin=getattr(ioconfig, "margin", 64),
        tile_shape=getattr(ioconfig, "tile_shape", (2048, 2048)),
        save_resolution={"units": "baseline", "resolution": 1.0},
    )


class TileServer:
    """Multi-layer Zoomify tile server.

    Args:
        title: Display title.
        layers: Mapping name → path/ndarray/WSIReader/AnnotationStore.
        renderer: AnnotationRenderer for store layers.
        model_runners: name -> callable taking a uint8 region and returning
            an instance dict (built from the registry when absent).
        prompt_segmentor: A ``PromptSegmentor`` (built when first asked for).
    """

    def __init__(
        self,
        title: str = "tiatoolbox-tpu",
        layers=None,
        renderer=None,
        model_runners: dict | None = None,
        prompt_segmentor=None,
    ) -> None:
        from tiatoolbox_tpu_torch.utils.visualization import AnnotationRenderer

        self.title = title
        # interactive model-run hooks (reference bokeh_app segment_on_box
        # / sam_segment, ``main.py:1443,1503``): name → callable taking a
        # uint8 region and returning an instance dict. Defaults are built
        # lazily from the pretrained registry; tests inject their own.
        self.model_runners: dict = dict(model_runners or {})
        self.prompt_segmentor = prompt_segmentor
        self.renderer = renderer if renderer is not None else AnnotationRenderer()
        self.layers: dict[str, object] = {}
        self.pyramids: dict[str, object] = {}
        # session_id -> {"layers", "pyramids", "base_info", "renderer"}
        # The constructor layers form the shared "default" session;
        # self.layers/self.pyramids alias its dicts.
        self.sessions: dict[str, dict] = {
            "default": {
                "layers": self.layers,
                "pyramids": self.pyramids,
                "base_info": None,
                "renderer": self.renderer,
            }
        }
        self._servers: list = []  # live WSGI servers, for /tileserver/shutdown
        for name, layer in (layers or {}).items():
            self.add_layer(name, layer)

    @property
    def _base_info(self):
        return self.sessions["default"]["base_info"]

    def _session(self, session_id: str) -> dict:
        if session_id not in self.sessions:
            from tiatoolbox_tpu_torch.utils.visualization import AnnotationRenderer

            self.sessions[session_id] = {
                "layers": {},
                "pyramids": {},
                "base_info": None,
                "renderer": AnnotationRenderer(),
            }
        return self.sessions[session_id]

    def add_layer(self, name: str, layer, session_id: str = "default") -> None:
        """Register a slide or annotation-store layer."""
        from tiatoolbox_tpu_torch.annotation.storage import AnnotationStore
        from tiatoolbox_tpu_torch.tools.pyramid import (
            AnnotationTileGenerator,
            ZoomifyGenerator,
        )
        from tiatoolbox_tpu_torch.utils import magic
        from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

        state = self._session(session_id)
        if isinstance(layer, AnnotationStore):
            if state["base_info"] is None:
                msg = "Add a slide layer before annotation layers."
                raise ValueError(msg)
            state["layers"][name] = layer
            state["pyramids"][name] = AnnotationTileGenerator(
                state["base_info"], layer, renderer=state["renderer"]
            )
            return
        if isinstance(layer, (str, Path)) and (
            magic.is_sqlite3(layer) or str(layer).endswith((".db", ".geojson",
                                                            ".ndjson"))
        ):
            store = AnnotationStore.open(layer)
            self.add_layer(name, store, session_id)
            return
        reader = WSIReader.open(layer)
        state["layers"][name] = reader
        state["pyramids"][name] = ZoomifyGenerator(reader)
        if state["base_info"] is None:
            state["base_info"] = reader.info

    # -- request handling -------------------------------------------------------

    _TILE_RE = re.compile(
        r"^/tileserver/layer/(?P<layer>[^/]+)/(?P<session>[^/]+)/zoomify/"
        r"TileGroup\d+/(?P<z>\d+)-(?P<x>\d+)-(?P<y>\d+)\.jpg$"
    )

    @staticmethod
    def _read_params(environ) -> dict:
        """Merge query-string and form-encoded body parameters."""
        from urllib.parse import parse_qs

        params = {
            k: v[-1]
            for k, v in parse_qs(environ.get("QUERY_STRING", "")).items()
        }
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if length:
            body = environ["wsgi.input"].read(length).decode()
            params.update({k: v[-1] for k, v in parse_qs(body).items()})
        return params

    def __call__(self, environ, start_response):
        """WSGI entry point."""
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET").upper()
        try:
            if path == "/":
                return self._respond_html(start_response, self._index_html())
            if path == "/viewer":
                from tiatoolbox_tpu_torch.visualization.viewer import render_viewer_html

                return self._respond_html(
                    start_response, render_viewer_html(self.title)
                )
            if path == "/tileserver/layers":
                return self._respond_json(
                    start_response, {"layers": list(self.layers.keys())}
                )
            match = self._TILE_RE.match(path)
            if match:
                return self._serve_tile(start_response, match)
            if path.startswith("/tileserver/info/"):
                return self._serve_info(start_response, path.rsplit("/", 1)[-1])
            if path.startswith("/tileserver/tap_query/"):
                parts = path.split("/")
                return self._serve_tap_query(
                    start_response, parts[-3], float(parts[-2]), float(parts[-1])
                )
            if path.startswith("/tileserver/"):
                return self._serve_control(
                    start_response, method, path[len("/tileserver/"):],
                    self._read_params(environ),
                )
            return self._respond_error(start_response, "404 Not Found", "not found")
        except Exception as exc:  # noqa: BLE001 - a failed request answers 500, the server goes on
            logger.warning("TileServer error for %s: %s", path, exc)
            return self._respond_error(
                start_response, "500 Internal Server Error", str(exc)
            )

    # -- session control API (reference tileserver.py:354-866) ---------------------

    def _serve_control(self, start_response, method: str, route: str, params: dict):
        """Dispatch the session-scoped control API."""
        sid = params.get("session_id", "default")
        state = self._session(sid)
        parts = route.strip("/").split("/")
        handler = {
            "session_id": self._ctl_session_id,
            "reset": self._ctl_reset,
            "slide": self._ctl_slide,
            "annotations": self._ctl_annotations,
            "overlay": self._ctl_overlay,
            "clear_overlays": self._ctl_clear_overlays,
            "color_prop": self._ctl_color_prop,
            "cmap": self._ctl_cmap,
            "renderer": self._ctl_renderer,
            "prop_names": self._ctl_prop_names,
            "prop_values": self._ctl_prop_values,
            "prop_range": self._ctl_prop_range,
            "prop_stats": self._ctl_prop_stats,
            "commit": self._ctl_commit,
            "channels": self._ctl_channels,
            "enhance": self._ctl_enhance,
            "segment_on_box": self._ctl_segment_on_box,
            "prompt_segment": self._ctl_prompt_segment,
            "graph": self._ctl_graph,
            "secondary_cmap": self._ctl_secondary_cmap,
            "sessions": self._ctl_sessions,
            "healthcheck": self._ctl_healthcheck,
            "shutdown": self._ctl_shutdown,
        }.get(parts[0])
        if handler is None:
            return self._respond_error(start_response, "404 Not Found", "not found")
        try:
            payload = handler(method, state, parts[1:], params)
        except KeyError as exc:
            return self._respond_error(
                start_response, "400 Bad Request", f"missing parameter: {exc}"
            )
        return self._respond_json(start_response, payload)

    def _ctl_session_id(self, method, state, extra, params):  # noqa: ARG002
        import uuid as _uuid

        sid = _uuid.uuid4().hex
        self._session(sid)
        return {"session_id": sid}

    def _ctl_reset(self, method, state, extra, params):  # noqa: ARG002
        sid = extra[0] if extra else params.get("session_id", "default")
        self.sessions.pop(sid, None)
        return {"reset": sid}

    def _ctl_slide(self, method, state, extra, params):  # noqa: ARG002
        from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

        if method == "GET":
            reader = state["layers"].get("slide")
            path = getattr(reader, "input_path", None) if reader else None
            return {"slide": str(path) if path else None}
        slide_path = params["slide_path"]
        # changing slide clears the session's layers (reference :409-424)
        state["layers"].clear()
        state["pyramids"].clear()
        state["base_info"] = None
        self.add_layer(
            "slide",
            WSIReader.open(slide_path),
            session_id=next(
                k for k, v in self.sessions.items() if v is state
            ),
        )
        return {"slide": slide_path}

    def _ctl_annotations(self, method, state, extra, params):  # noqa: ARG002
        from tiatoolbox_tpu_torch.annotation.storage import AnnotationStore, SQLiteStore

        if method == "GET":
            overlay = state["layers"].get("overlay")
            return {"count": len(overlay) if overlay is not None else 0}
        store = AnnotationStore.open(params["file_path"])
        if not isinstance(store, SQLiteStore):  # pragma: no cover - dict stores
            pass
        mpp = params.get("model_mpp")
        if mpp and state["base_info"] is not None and state["base_info"].mpp is not None:
            # rescale annotations from model resolution to slide baseline
            factor = float(mpp) / float(state["base_info"].mpp[0])
            if factor != 1.0:
                store.transform(lambda coords, f=factor: np.asarray(coords) * f)
        sid = next(k for k, v in self.sessions.items() if v is state)
        self.add_layer("overlay", store, session_id=sid)
        types = sorted(
            {
                str(a.properties.get("type"))
                for a in store.values()
                if a.properties.get("type") is not None
            }
        )
        return {"types": types}

    def _ctl_overlay(self, method, state, extra, params):  # noqa: ARG002
        overlay_path = Path(params["overlay_path"])
        sid = next(k for k, v in self.sessions.items() if v is state)
        if overlay_path.suffix.lower() in (".npy", ".mha"):
            return self._registration_overlay(state, overlay_path)
        if overlay_path.suffix.lower() == ".dat":
            from tiatoolbox_tpu_torch.utils.misc import store_from_dat

            store = store_from_dat(overlay_path)
            self.add_layer("overlay", store, session_id=sid)
            types = sorted(
                {
                    str(a.properties.get("type"))
                    for a in store.values()
                    if a.properties.get("type") is not None
                }
            )
            return {"types": types}
        if overlay_path.suffix.lower() in (".db", ".geojson", ".ndjson"):
            return self._ctl_annotations(
                "PUT", state, extra, {**params, "file_path": str(overlay_path)}
            )
        n = sum(1 for name in state["layers"] if name.startswith("layer"))
        name = f"layer{n}"
        self.add_layer(name, overlay_path, session_id=sid)
        return {"layer": name}

    def _registration_overlay(self, state, overlay_path: Path) -> dict:
        """Re-read the slide through a registration transform file.

        Mirrors the reference's ``_handle_registration_overlay``
        (reference ``visualization/tileserver.py:544-592``): a ``.npy``
        (affine or displacement field) or SimpleITK-written ``.mha``
        displacement field wraps the session's slide in a
        :class:`TransformedWSIReader`. If another session holds a slide
        (split-view), that slide's frame is the fixed frame.
        """
        from tiatoolbox_tpu_torch.tools.pyramid import ZoomifyGenerator
        from tiatoolbox_tpu_torch.utils.metaimage import load_transform
        from tiatoolbox_tpu_torch.wsicore.store_reader import TransformedWSIReader

        transform = load_transform(overlay_path)
        moving = state["layers"].get("slide")
        if moving is None:
            msg = "Load a slide before a registration transform."
            raise ValueError(msg)
        # Replace semantics (reference rebuilds from the original slide
        # path): a refined transform must not compose with the previous
        # one, so unwrap any TransformedWSIReader back to its base slide.
        while isinstance(moving, TransformedWSIReader):
            moving = moving.reader
        fixed_info = None
        for sess in self.sessions.values():
            if sess is not state and sess["layers"].get("slide") is not None:
                fixed_info = sess["layers"]["slide"].info
                break
        reader = TransformedWSIReader(moving, transform, fixed_info=fixed_info)
        state["layers"]["slide"] = reader
        state["pyramids"]["slide"] = ZoomifyGenerator(reader)
        state["base_info"] = reader.info
        return {"layer": "slide"}

    def _ctl_clear_overlays(self, method, state, extra, params):  # noqa: ARG002
        removed = [
            name
            for name in list(state["layers"])
            if name == "overlay" or name.startswith("layer")
        ]
        for name in removed:
            state["layers"].pop(name, None)
            state["pyramids"].pop(name, None)
        return {"removed": removed}

    def _ctl_color_prop(self, method, state, extra, params):  # noqa: ARG002
        if method == "GET":
            return {"color_prop": state["renderer"].score_prop}
        state["renderer"].score_prop = params.get("prop") or None
        return {"color_prop": state["renderer"].score_prop}

    def _ctl_cmap(self, method, state, extra, params):  # noqa: ARG002
        if method == "GET":
            mapper = state["renderer"].mapper
            return {"cmap": mapper if isinstance(mapper, str) else "custom"}
        cmap = params["cmap"]
        if cmap.startswith("{"):
            mapping = json.loads(cmap)
            state["renderer"].mapper = {
                key: tuple(value) for key, value in mapping.items()
            }
        else:
            state["renderer"].mapper = cmap
        return {"cmap": cmap}

    def _ctl_renderer(self, method, state, extra, params):
        prop = extra[0]
        renderer = state["renderer"]
        if method == "GET":
            value = getattr(renderer, prop)
            return {prop: value if not callable(value) else str(value)}
        value = params["val"]
        try:
            value = json.loads(value)
        except (ValueError, TypeError):
            pass
        setattr(renderer, prop, value)
        return {prop: value}

    def _ctl_prop_names(self, method, state, extra, params):  # noqa: ARG002
        overlay = state["layers"].get("overlay")
        if overlay is None:
            return {"prop_names": []}
        ann_type = extra[0] if extra else "all"
        keys: set = set()
        for ann in overlay.values():
            if ann_type in ("all", str(ann.properties.get("type"))):
                keys.update(ann.properties.keys())
        return {"prop_names": sorted(keys)}

    def _ctl_prop_values(self, method, state, extra, params):  # noqa: ARG002
        overlay = state["layers"].get("overlay")
        if overlay is None:
            return {"prop_values": []}
        prop = extra[0]
        ann_type = extra[1] if len(extra) > 1 else "all"
        values = {
            ann.properties[prop]
            for ann in overlay.values()
            if prop in ann.properties
            and ann_type in ("all", str(ann.properties.get("type")))
        }
        return {"prop_values": sorted(values, key=str)}

    def _ctl_prop_range(self, method, state, extra, params):  # noqa: ARG002
        overlay = state["layers"].get("overlay")
        prop = params.get("prop") or (extra[0] if extra else None)
        if overlay is None or prop is None:
            return {"range": None}
        values = [
            float(ann.properties[prop])
            for ann in overlay.values()
            if isinstance(ann.properties.get(prop), (int, float))
        ]
        if not values:
            return {"range": None}
        lo, hi = min(values), max(values)
        if method != "GET":  # PUT also primes the continuous colormap
            state["renderer"].score_range = (lo, hi)
        return {"range": [lo, hi]}

    def _ctl_prop_stats(self, method, state, extra, params):  # noqa: ARG002
        """Summary stats + histogram for a property (viewer stats pane).

        Numeric: count/min/max/mean + ``bins``-bucket histogram.
        Categorical: value counts. Reference analog: the bokeh app's
        property histograms (``bokeh_app/main.py``).
        """
        overlay = state["layers"].get("overlay")
        prop = extra[0] if extra else params.get("prop")
        if overlay is None or not prop:
            return {"stats": None}
        values = [
            ann.properties[prop]
            for ann in overlay.values()
            if prop in ann.properties
        ]
        if not values:
            return {"stats": None}
        # bool is an int subclass but belongs in value counts, and
        # non-finite floats would make np.histogram raise
        numeric = [
            v
            for v in values
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        ]
        if len(numeric) == len(values):
            arr = np.asarray(numeric, float)
            arr = arr[np.isfinite(arr)]
            if arr.size == 0:
                return {"stats": None}
            bins = int(params.get("bins", 20))
            hist, edges = np.histogram(arr, bins=bins)
            return {
                "stats": {
                    "kind": "numeric",
                    "count": int(arr.size),
                    "min": float(arr.min()),
                    "max": float(arr.max()),
                    "mean": float(arr.mean()),
                    "hist": hist.tolist(),
                    "edges": edges.tolist(),
                }
            }
        counts: dict = {}
        for v in values:
            counts[str(v)] = counts.get(str(v), 0) + 1
        return {"stats": {"kind": "categorical", "count": len(values),
                          "value_counts": counts}}

    def _ctl_commit(self, method, state, extra, params):  # noqa: ARG002
        from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore

        overlay = state["layers"].get("overlay")
        if not isinstance(overlay, SQLiteStore):
            return {"committed": False}
        save_path = params.get("save_path")
        if save_path:
            overlay.dump(save_path)
        else:
            overlay.commit()
        return {"committed": True}

    # -- interactive model runs (reference bokeh_app/main.py:1443-1600) ------------

    def _session_id_of(self, state) -> str:
        return next(k for k, v in self.sessions.items() if v is state)

    def _segment_runner(self, model_name: str):
        """Instance-segmentation runner for a registry model (cached).

        The runner takes a uint8 RGB region (already at the model's
        working resolution) and returns the engine's instance dict
        ({uuid: {box, centroid, contours, prob, type}}) in region
        pixel coordinates.
        """
        if model_name in self.model_runners:
            return self.model_runners[model_name]

        from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
        from tiatoolbox_tpu_torch.models.engine.multi_task_segmentor import (
            MultiTaskSegmentor,
        )

        model, ioconfig = get_pretrained_model(model_name)
        base_cfg = region_ioconfig(ioconfig)
        engine = MultiTaskSegmentor(model, batch_size=4, num_loader_workers=0, verbose=False)

        def run(region: np.ndarray) -> dict:
            out = engine.run(
                [region], patch_mode=False, ioconfig=base_cfg,
                auto_get_mask=False,
            )
            return next(iter(out.values())).get("instances", {})

        self.model_runners[model_name] = run
        return run

    def _model_mpp(self, model_name: str):
        from tiatoolbox_tpu_torch import PRETRAINED_MODELS

        cfg = PRETRAINED_MODELS.get(model_name, {})
        res = (cfg.get("ioconfig", {}).get("kwargs", {})
               .get("input_resolutions", [{}]))[0]
        if res.get("units") == "mpp":
            return float(res["resolution"])
        return None

    def _ctl_segment_on_box(self, method, state, extra, params):  # noqa: ARG002
        """Run an instance segmentor on a drawn box; add a "segment"
        overlay layer (reference ``bokeh_app/main.py:1443-1501``)."""
        from tiatoolbox_tpu_torch.annotation.geometry import Polygon
        from tiatoolbox_tpu_torch.annotation.storage import Annotation, SQLiteStore

        x0, y0, x1, y1 = (
            float(params[k]) for k in ("x0", "y0", "x1", "y1")
        )
        x0, x1 = sorted((x0, x1))
        y0, y1 = sorted((y0, y1))
        model_name = params.get("model", "hovernet_fast-pannuke")
        reader = state["layers"].get("slide") or next(
            iter(state["layers"].values()), None
        )
        if reader is None:
            msg = "slide"
            raise KeyError(msg)
        model_mpp = self._model_mpp(model_name)
        slide_mpp = (
            float(state["base_info"].mpp[0])
            if state["base_info"] is not None and state["base_info"].mpp is not None
            else None
        )
        if model_mpp is not None and slide_mpp is not None:
            region = reader.read_bounds(
                (int(x0), int(y0), int(x1), int(y1)),
                resolution=model_mpp, units="mpp",
            )
            factor = model_mpp / slide_mpp
        else:
            region = reader.read_bounds(
                (int(x0), int(y0), int(x1), int(y1)), resolution=0,
                units="level",
            )
            factor = 1.0
        instances = self._segment_runner(model_name)(np.asarray(region))
        store = SQLiteStore()
        annotations = []
        for info in instances.values():
            contour = np.asarray(info["contours"], float)
            if contour.ndim != 2 or len(contour) < 3:
                continue
            shell = contour * factor + np.array([x0, y0])
            props = {
                "type": (
                    int(info["type"]) if info.get("type") is not None else None
                ),
                "prob": (
                    float(info["prob"]) if info.get("prob") is not None else None
                ),
            }
            annotations.append(Annotation(Polygon(shell), props))
        store.append_many(annotations)
        self.add_layer("segment", store, session_id=self._session_id_of(state))
        types = sorted(
            {a.properties["type"] for a in annotations
             if a.properties.get("type") is not None}
        )
        return {"count": len(annotations), "types": types, "layer": "segment"}

    def _ctl_prompt_segment(self, method, state, extra, params):  # noqa: ARG002
        """Prompt-based (SAM) segmentation from viewer points/boxes;
        adds a "prompt" overlay layer (reference ``main.py:1503-1600``)."""
        import tempfile

        from tiatoolbox_tpu_torch.annotation.storage import AnnotationStore

        points = json.loads(params.get("points", "null"))
        box = json.loads(params.get("box", "null"))
        if not points and not box:
            msg = "points"
            raise KeyError(msg)
        reader = state["layers"].get("slide") or next(
            iter(state["layers"].values()), None
        )
        if reader is None:
            msg = "slide"
            raise KeyError(msg)
        # read window: the prompt box, or the points' bbox + margin
        margin = 256
        coords = np.asarray(box, float).reshape(-1, 2) if box else np.asarray(
            points, float
        )
        bx0, by0 = coords.min(axis=0) - (0 if box else margin)
        bx1, by1 = coords.max(axis=0) + (0 if box else margin)
        segmentor = self.prompt_segmentor
        if segmentor is None:
            try:
                from tiatoolbox_tpu_torch.models.engine.prompt_segmentor import (
                    PromptSegmentor,
                )

                segmentor = self.prompt_segmentor = PromptSegmentor()
            except Exception as exc:
                msg = f"SAM weights unavailable: {exc}"
                raise KeyError(msg) from exc
        region = reader.read_bounds(
            (int(bx0), int(by0), int(bx1), int(by1)), resolution=0,
            units="level",
        )
        segmentor.scale = 1.0
        segmentor.offset = np.array([bx0, by0])
        local_points = (
            np.asarray(points, float)[None] - [bx0, by0] if points else None
        )
        local_box = (
            (np.asarray(box, float).reshape(-1) - [bx0, by0, bx0, by0])[None, None]
            if box
            else None
        )
        with tempfile.TemporaryDirectory() as tmp:
            paths = segmentor.run(
                [np.asarray(region)],
                point_coords=local_points,
                box_coords=local_box,
                save_dir=tmp,
            )
            # copy into an in-memory store: the on-disk .db vanishes
            # with the temp dir while the layer lives on
            from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore

            saved = AnnotationStore.open(paths[0])
            store = SQLiteStore()
            store.append_many(list(saved.values()))
        n = len(store)
        self.add_layer("prompt", store, session_id=self._session_id_of(state))
        return {"count": n, "layer": "prompt"}

    def _ctl_graph(self, method, state, extra, params):  # noqa: ARG002
        """Load a SlideGraph as node/edge overlay layers with
        per-feature node coloring (reference ``main.py:682,1286-1297``)."""
        from tiatoolbox_tpu_torch.annotation.geometry import LineString, Point
        from tiatoolbox_tpu_torch.annotation.storage import Annotation, SQLiteStore

        if method == "GET":
            nodes = state["layers"].get("graph_nodes")
            return {"nodes": len(nodes) if nodes is not None else 0}
        graph_path = params.get("graph_path")
        if graph_path:
            path = Path(graph_path)
            if path.suffix.lower() == ".npz":
                data = dict(np.load(path, allow_pickle=False))
            else:
                data = json.loads(path.read_text())
        else:
            data = json.loads(params["graph"])
        coords = np.asarray(
            data.get("coordinates", data.get("coords")), float
        ).reshape(-1, 2)
        edge_index = np.asarray(
            data.get("edge_index", np.zeros((2, 0))), int
        ).reshape(2, -1)
        feats = data.get("x", data.get("feats"))
        feats = np.asarray(feats, float) if feats is not None else None
        mpp = params.get("model_mpp")
        if mpp and state["base_info"] is not None and state["base_info"].mpp is not None:
            coords = coords * (float(mpp) / float(state["base_info"].mpp[0]))
        degree = np.zeros(len(coords), int)
        for end in edge_index:
            for v in end:
                degree[v] += 1
        n_feats = min(int(feats.shape[1]), 8) if feats is not None else 0
        node_annotations = []
        for i, (cx, cy) in enumerate(coords):
            props = {"degree": int(degree[i])}
            for f in range(n_feats):
                props[f"feat_{f}"] = float(feats[i, f])
            node_annotations.append(Annotation(Point(cx, cy), props))
        nodes = SQLiteStore()
        nodes.append_many(node_annotations)
        edges = SQLiteStore()
        edges.append_many(
            [
                Annotation(
                    LineString([coords[a], coords[b]]), {"edge": 1}
                )
                for a, b in edge_index.T
                if not np.array_equal(coords[a], coords[b])
            ]
        )
        sid = self._session_id_of(state)
        self.add_layer("graph_nodes", nodes, session_id=sid)
        self.add_layer("graph_edges", edges, session_id=sid)
        return {
            "nodes": len(nodes),
            "edges": len(edges),
            "node_props": ["degree"] + [f"feat_{f}" for f in range(n_feats)],
        }

    def _multichannel_post_proc(self, state):
        from tiatoolbox_tpu_torch.utils.postproc_defs import MultichannelToRGB

        reader = state["layers"].get("slide") or next(
            iter(state["layers"].values()), None
        )
        post_proc = getattr(reader, "post_proc", None)
        return post_proc if isinstance(post_proc, MultichannelToRGB) else None

    def _ctl_secondary_cmap(self, method, state, extra, params):  # noqa: ARG002
        """Type-specific colour override (reference tileserver.py change_secondary_cmap)."""
        renderer = state["renderer"]
        if method == "GET":
            sec = getattr(renderer, "secondary_cmap", None)
            if sec is None:
                return {"secondary_cmap": None}
            mapper = sec.get("mapper")
            return {
                "secondary_cmap": {
                    "type": sec.get("type"),
                    "score_prop": sec.get("score_prop"),
                    "cmap": mapper if isinstance(mapper, str) else "custom",
                }
            }
        type_id = params["type_id"]
        try:
            type_id = json.loads(type_id)
        except (ValueError, TypeError):
            pass
        cmap = params["cmap"]
        mapper = (
            {key: tuple(value) for key, value in json.loads(cmap).items()}
            if cmap.startswith("{")
            else cmap
        )
        renderer.secondary_cmap = {
            "type": type_id,
            "score_prop": params["prop"],
            "mapper": mapper,
        }
        return {"secondary_cmap": "done"}

    def _ctl_sessions(self, method, state, extra, params):  # noqa: ARG002
        """Map of session id -> slide path (reference tileserver.py sessions)."""
        out = {}
        for sid, sess in self.sessions.items():
            reader = sess["layers"].get("slide")
            path = getattr(reader, "input_path", None) if reader else None
            out[sid] = str(path) if path else ""
        return {"sessions": out}

    def _ctl_healthcheck(self, method, state, extra, params):  # noqa: ARG002
        return {"status": "OK"}

    def _ctl_shutdown(self, method, state, extra, params):  # noqa: ARG002
        """Stop every server loop started via run()/run_in_thread().

        ``shutdown()`` only exits the ``serve_forever`` loop; the listening
        socket would keep accepting connections into the kernel backlog
        (where clients then hang), so the stopper thread also closes it.
        """
        servers = list(self._servers)

        def _stop(server) -> None:
            server.shutdown()  # blocks until serve_forever has exited
            server.server_close()
            try:
                self._servers.remove(server)
            except ValueError:  # pragma: no cover - already removed by run()
                pass

        for server in servers:
            threading.Thread(target=_stop, args=(server,), daemon=True).start()
        return {"status": "shutting down", "servers": len(servers)}

    @staticmethod
    def _parse_channel_color(value) -> tuple:
        """'#rrggbb' or [r, g, b] (0-1 floats) → RGB tuple in [0, 1]."""
        if isinstance(value, str) and value.startswith("#"):
            return tuple(int(value[i : i + 2], 16) / 255 for i in (1, 3, 5))
        return tuple(float(x) for x in value)

    def _ctl_channels(self, method, state, extra, params):  # noqa: ARG002
        """Multichannel (fluorescence) channel control.

        GET returns names/colors/active; PUT accepts the reference
        ``set_channels`` form (reference ``tileserver.py:841-850``):
        ``channels`` = JSON color dict (name → rgb or '#hex') and
        ``active`` = JSON list of channel indices. A JSON list in
        ``channels`` is also accepted as the active list (legacy form).
        """
        post_proc = self._multichannel_post_proc(state)
        if post_proc is None:
            return {
                "channels": None, "colors": None, "names": None,
                "active": None,
            }
        if method != "GET":
            if "channels" in params:
                val = json.loads(params["channels"])
                if isinstance(val, dict):
                    post_proc.color_dict = {
                        k: self._parse_channel_color(v) for k, v in val.items()
                    }
                    post_proc.is_validated = False
                else:
                    post_proc.set_active_channels(val)
            if "active" in params:
                post_proc.set_active_channels(json.loads(params["active"]))
        colors = (
            np.asarray(post_proc.colors).tolist()
            if post_proc.colors is not None
            else None
        )
        names = list(post_proc.color_dict) if post_proc.color_dict else None
        return {
            "channels": post_proc.channels,
            "colors": colors,
            "names": names,
            "active": post_proc.channels,
        }

    def _ctl_enhance(self, method, state, extra, params):  # noqa: ARG002
        post_proc = self._multichannel_post_proc(state)
        if post_proc is None:
            return {"enhance": None}
        if method != "GET":
            post_proc.enhance = float(params["val"])
        return {"enhance": post_proc.enhance}

    def _serve_tile(self, start_response, match):
        layer = match.group("layer")
        session = match.group("session")
        z, x, y = (int(match.group(k)) for k in ("z", "x", "y"))
        pyramids = self.sessions.get(session, self.sessions["default"])["pyramids"]
        if layer not in pyramids:
            pyramids = self.pyramids  # fall back to the shared session
        if layer not in pyramids:
            return self._respond_error(start_response, "404 Not Found", "no layer")
        try:
            tile = pyramids[layer].get_tile(z, x, y)
        except IndexError:
            return self._respond_error(start_response, "404 Not Found", "no tile")
        tile = np.ascontiguousarray(tile, dtype=np.uint8)
        if tile.shape[-1] == 4:
            from tiatoolbox_tpu_torch.utils.misc import _png_bytes

            data = _png_bytes(tile)
            content_type = "image/png"
        else:
            from tiatoolbox_tpu_torch import native

            data = native.encode_jpeg(tile, 85)
            content_type = "image/jpeg"
        start_response(
            "200 OK",
            [("Content-Type", content_type), ("Content-Length", str(len(data)))],
        )
        return [data]

    def _serve_info(self, start_response, layer: str):
        from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

        if layer not in self.layers:
            return self._respond_error(start_response, "404 Not Found", "no layer")
        obj = self.layers[layer]
        if isinstance(obj, WSIReader):
            info = obj.info.as_dict()
            info = {
                k: (str(v) if isinstance(v, Path) else np.asarray(v).tolist()
                    if isinstance(v, (np.ndarray, tuple, list)) else v)
                for k, v in info.items()
            }
            return self._respond_json(start_response, info)
        return self._respond_json(start_response, {"type": "annotation", "count": len(obj)})

    def _serve_tap_query(self, start_response, layer: str, x: float, y: float):
        from tiatoolbox_tpu_torch.annotation.storage import AnnotationStore

        obj = self.layers.get(layer)
        if not isinstance(obj, AnnotationStore):
            return self._respond_error(start_response, "404 Not Found", "no store")
        hits = obj.query((x - 2, y - 2, x + 2, y + 2))
        props = [ann.properties for ann in hits.values()]
        return self._respond_json(start_response, {"annotations": props})

    # -- responses ------------------------------------------------------------------

    @staticmethod
    def _respond_json(start_response, payload: dict):
        data = json.dumps(payload).encode()
        start_response(
            "200 OK",
            [("Content-Type", "application/json"), ("Content-Length", str(len(data)))],
        )
        return [data]

    @staticmethod
    def _respond_html(start_response, html: str):
        data = html.encode()
        start_response(
            "200 OK",
            [("Content-Type", "text/html"), ("Content-Length", str(len(data)))],
        )
        return [data]

    @staticmethod
    def _respond_error(start_response, status: str, message: str):
        data = json.dumps({"error": message}).encode()
        start_response(
            status,
            [("Content-Type", "application/json"), ("Content-Length", str(len(data)))],
        )
        return [data]

    def _index_html(self) -> str:
        layer_list = "".join(
            f"<li><a href='/tileserver/info/{name}'>{name}</a></li>"
            for name in self.layers
        )
        return (
            f"<html><head><title>{self.title}</title></head><body>"
            f"<h1>{self.title}</h1><ul>{layer_list}</ul>"
            "<p>Tiles at /tileserver/layer/&lt;layer&gt;/default/zoomify/"
            "TileGroup0/z-x-y.jpg</p></body></html>"
        )

    # -- running -------------------------------------------------------------------

    def run(self, host: str = "127.0.0.1", port: int = 5000) -> None:
        """Serve forever (blocking; /tileserver/shutdown stops the loop)."""
        server = make_server(host, port, self)
        self._servers.append(server)
        try:
            server.serve_forever()
        finally:
            self._servers.remove(server)

    def run_in_thread(self, host: str = "127.0.0.1", port: int = 0):
        """Start serving on a daemon thread; returns (server, port)."""
        server = make_server(host, port, self, server_class=WSGIServer)
        self._servers.append(server)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, server.server_address[1]
