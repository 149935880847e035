"""Annotation storage (counterpart of ``tiatoolbox_tpu/annotation/storage.py:1-1089``).

MutableMapping stores with spatial queries. The code is JAX's, with the
port's own geometry, DSL, enum and file sniffing; a ``.db`` written by
either package opens in the other (the same schema, metadata keys and
zlib-compressed WKB).

Reference: ``tiatoolbox/annotation/storage.py`` (Annotation :111-442,
AnnotationStore ABC :443-2248, SQLiteStore :2310-3964, DictionaryStore
:3965-4128). Geometry comes from ``annotation.geometry`` (own WKB
codecs) instead of Shapely; the SQLite backend uses the stdlib sqlite3
R*Tree with zlib-compressed WKB blobs — same perf-critical design as
the reference's C SQLite path.
"""

from __future__ import annotations

import contextlib
import json
import sqlite3
import threading
import uuid
import zlib
from collections.abc import MutableMapping
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.annotation import dsl
from tiatoolbox_tpu_torch.annotation.geometry import (
    Geometry,
    Point,
    Polygon,
    geojson_to_geometry,
    geometry_contains,
    geometry_intersects,
    wkb_to_geometry,
    wkt_to_geometry,
)


# zlib level of a new store's geometry blobs. JAX's stores declare 9; the
# port's declare zlib's default, 6: as small on WKB coordinates, and ten
# times faster on a large polygon (level 9 took 30 s on one 36 MB polygon
# with thousands of holes). Either opens in either package.
ZLIB_LEVEL = 6


@dataclass
class Annotation:
    """A geometry plus JSON-serializable properties."""

    geometry: Geometry
    properties: dict = field(default_factory=dict)

    @property
    def coords(self) -> np.ndarray:
        return self.geometry.coords

    @property
    def geometry_type(self):
        """The :class:`~tiatoolbox_tpu_torch.enums.GeometryType` of the
        geometry (reference ``annotation/storage.py:148``)."""
        from tiatoolbox_tpu_torch.enums import GeometryType

        return GeometryType(self.geometry.geom_type)

    def to_feature(self) -> dict:
        """GeoJSON feature dict."""
        return {
            "type": "Feature",
            "geometry": self.geometry.to_geojson_dict(),
            "properties": self.properties,
        }

    def to_geojson(self) -> str:
        """GeoJSON feature string."""
        return json.dumps(self.to_feature())

    def to_wkb(self) -> bytes:
        return self.geometry.to_wkb()

    def to_wkt(self) -> str:
        return self.geometry.to_wkt()

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Annotation):
            return NotImplemented
        return (
            self.geometry == other.geometry and self.properties == other.properties
        )

    def __hash__(self) -> int:
        return hash((self.geometry.to_wkb(), json.dumps(self.properties, sort_keys=True)))


def _to_geometry(geometry) -> Geometry:
    """Coerce bounds tuples / geojson dicts to a Geometry."""
    if isinstance(geometry, Geometry):
        return geometry
    if isinstance(geometry, dict):
        return geojson_to_geometry(geometry)
    arr = np.asarray(geometry, dtype=float).ravel()
    if arr.size == 4:
        return Polygon.from_bounds(*arr)
    if arr.size == 2:
        return Point(arr[0], arr[1])
    msg = f"Cannot interpret {geometry!r} as a geometry."
    raise TypeError(msg)


_PREDICATES = {
    "intersects": geometry_intersects,
    "contains": lambda a, b: geometry_contains(b, a),  # query geom contains ann
    "within": lambda a, b: geometry_contains(a, b),  # ann within query geom
    "bbox_intersects": lambda a, b: a.bbox_intersects(b),
    "centers_within_k": None,  # handled separately in nquery
}


class AnnotationStore(MutableMapping):
    """Abstract store: MutableMapping[str, Annotation] + spatial queries."""

    # -- open/dispatch -------------------------------------------------------

    @classmethod
    def open(cls, fp) -> "AnnotationStore":
        """Open a store file by sniffing type (.db → SQLite, else dict/json)."""
        from tiatoolbox_tpu_torch.utils import magic

        path = Path(fp)
        if magic.is_sqlite3(path) or path.suffix == ".db":
            return SQLiteStore(path)
        return DictionaryStore.from_geojson(path)

    # -- bulk operations --------------------------------------------------------

    def append(self, annotation: Annotation, key: str | None = None) -> str:
        """Insert one annotation; returns its key."""
        (result,) = self.append_many([annotation], [key] if key else None)
        return result

    def append_many(self, annotations, keys=None) -> list[str]:
        """Insert many annotations; returns the keys used."""
        annotations = list(annotations)
        if keys is None:
            keys = [str(uuid.uuid4()) for _ in annotations]
        keys = list(keys)
        if len(keys) != len(annotations):
            msg = "Number of keys must match number of annotations."
            raise ValueError(msg)
        for key, ann in zip(keys, annotations):
            self[key] = ann
        return keys

    def patch(self, key: str, geometry=None, properties=None) -> None:
        """Update geometry and/or merge properties for one key."""
        self.patch_many([key], [geometry], [properties])

    def patch_many(self, keys, geometries=None, properties_iter=None) -> None:
        keys = list(keys)
        geometries = list(geometries) if geometries is not None else [None] * len(keys)
        properties_iter = (
            list(properties_iter) if properties_iter is not None else [None] * len(keys)
        )
        if not len(keys) == len(geometries) == len(properties_iter):
            msg = "keys, geometries, and properties_iter must match in length."
            raise ValueError(msg)
        for key, geom, props in zip(keys, geometries, properties_iter):
            if key in self:
                existing = self[key]
                new_geom = _to_geometry(geom) if geom is not None else existing.geometry
                new_props = dict(existing.properties)
                if props:
                    new_props.update(props)
                self[key] = Annotation(new_geom, new_props)
            else:
                self[key] = Annotation(
                    _to_geometry(geom), dict(props) if props else {}
                )

    def remove(self, key: str) -> None:
        del self[key]

    def remove_many(self, keys) -> None:
        for key in keys:
            del self[key]

    def setdefault(self, key: str, default: Annotation | None = None) -> Annotation:
        if not isinstance(default, Annotation):
            msg = "default value must be an Annotation instance."
            raise TypeError(msg)
        return super().setdefault(key, default)

    def __contains__(self, key: object) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    # -- predicate machinery -------------------------------------------------------

    @staticmethod
    def _eval_where(where, properties: dict) -> bool:
        """Evaluate a where predicate (None / str DSL / callable)."""
        if where is None:
            return True
        if callable(where):
            return bool(where(properties))
        if isinstance(where, str):
            try:
                return bool(
                    eval(  # noqa: S307 - documented DSL behaviour
                        where, dsl.PY_GLOBALS, {"props": properties}
                    )
                )
            except KeyError:  # annotations lacking the property don't match
                return False
        msg = f"Invalid where predicate type: {type(where)}"
        raise TypeError(msg)

    @staticmethod
    def _geometry_predicate(name: str):
        if name not in _PREDICATES or _PREDICATES[name] is None:
            msg = f"Invalid geometry predicate: {name}"
            raise ValueError(msg)
        return _PREDICATES[name]

    # -- queries (generic implementations; backends may override) --------------------

    def query(
        self,
        geometry=None,
        where=None,
        geometry_predicate: str = "intersects",
        min_area: float | None = None,
        distance: float = 0,
    ) -> dict[str, Annotation]:
        """Annotations intersecting a geometry/bounds and matching where."""
        if geometry is None and where is None:
            msg = "At least one of geometry or where must be provided."
            raise ValueError(msg)
        query_geom = _to_geometry(geometry) if geometry is not None else None
        if query_geom is not None and distance > 0:
            query_geom = query_geom.buffer(distance)
        predicate = self._geometry_predicate(geometry_predicate)
        result = {}
        for key, ann in self.items():
            if min_area is not None and ann.geometry.area < min_area:
                continue
            if query_geom is not None:
                if not ann.geometry.bbox_intersects(query_geom):
                    continue
                if not predicate(ann.geometry, query_geom):
                    continue
            if not self._eval_where(where, ann.properties):
                continue
            result[key] = ann
        return result

    def iquery(
        self,
        geometry=None,
        where=None,
        geometry_predicate: str = "intersects",
        distance: float = 0,
    ) -> list[str]:
        """Keys of matching annotations."""
        return list(
            self.query(
                geometry, where, geometry_predicate, distance=distance
            ).keys()
        )

    def bquery(self, geometry=None, where=None) -> dict[str, tuple]:
        """Bounding boxes of matching annotations (bbox-only filter)."""
        query_geom = _to_geometry(geometry) if geometry is not None else None
        result = {}
        for key, ann in self.items():
            if query_geom is not None and not ann.geometry.bbox_intersects(query_geom):
                continue
            if not self._eval_where(where, ann.properties):
                continue
            result[key] = tuple(ann.geometry.bounds)
        return result

    def pquery(
        self,
        select,
        geometry=None,
        where=None,
        *,
        unique: bool = True,
        squeeze: bool = True,
    ):
        """Query selected property values.

        Args:
            select: "*" for full properties, a DSL string, or callable.
            unique: Return set(s) of unique values instead of per-key.
            squeeze: With unique and a single select, return the set
                directly.
        """
        if select != "*" and not isinstance(select, str) and not callable(select):
            msg = "select must be '*', a DSL string, or a callable."
            raise TypeError(msg)
        if select == "*" and unique:
            msg = "unique=True cannot be used with select='*'."
            raise ValueError(msg)

        def get_value(properties: dict):
            if select == "*":
                return properties
            if callable(select):
                return select(properties)
            return eval(  # noqa: S307
                select, dsl.PY_GLOBALS, {"props": properties}
            )

        matches = self.query(geometry, where) if geometry is not None or where else dict(self.items())
        if unique:
            values = set()
            for ann in matches.values():
                with contextlib.suppress(KeyError):
                    values.add(get_value(ann.properties))
            return values if squeeze else [values]
        return {key: get_value(ann.properties) for key, ann in matches.items()}

    def nquery(
        self,
        geometry=None,
        where=None,
        n_where=None,
        distance: float = 5.0,
        geometry_predicate: str = "centers_within_k",
        mode: str = "poly-poly",  # noqa: ARG002 - API parity
    ) -> dict[str, dict[str, Annotation]]:
        """Proximity query: neighbours within ``distance`` of matches.

        Mode semantics follow the reference (``storage.py:1543-1740``):

        - ``"box-box"``: neighbour bbox intersects the center's bbox
          expanded by ``distance`` (pure bbox arithmetic, no geometry
          decode).
        - ``"boxpoint-boxpoint"``: bbox-center to bbox-center distance
          (the reference's ``centers_within_k`` is defined on bounds
          centroids, ``storage.py:961-981``).
        - ``"poly-poly"`` (default): with the default
          ``geometry_predicate="centers_within_k"`` this is the
          boxpoint path; any other predicate uses true
          geometry-to-geometry distance (equivalent to the reference's
          buffer-then-intersect formulation).

        Unlike the reference's naive loop the center annotation itself
        is never returned as its own neighbour.

        Two-phase evaluation: one ``bquery`` pass gathers every
        ``n_where`` candidate's bounding box (R*Tree + SQL pushdown on
        the SQLite backend), the per-center tests run vectorized over
        that array, and only ``poly-poly`` survivors pay an exact
        geometry check — O(N + hits) instead of the all-pairs scan.
        """
        mode_tuple = tuple(mode.split("-")) if isinstance(mode, str) else tuple(mode)
        if mode_tuple not in (
            ("box", "box"), ("boxpoint", "boxpoint"), ("poly", "poly")
        ):
            msg = (
                "mode must be one of 'box-box', 'boxpoint-boxpoint', "
                "or 'poly-poly'"
            )
            raise ValueError(msg)
        from_mode = mode_tuple[0]

        centers = {
            key: ann
            for key, ann in self.query(
                geometry or (-1e300, -1e300, 1e300, 1e300), where, "bbox_intersects"
            ).items()
        }
        result: dict[str, dict[str, Annotation]] = {}
        if not centers:
            return result
        cand_boxes = self.bquery(None, n_where)
        cand_keys = list(cand_boxes)
        boxes = np.asarray(
            [cand_boxes[k] for k in cand_keys], dtype=np.float64
        ).reshape(-1, 4)
        cand_cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cand_cy = (boxes[:, 1] + boxes[:, 3]) / 2
        ann_cache: dict[str, Annotation] = {}

        def _ann(nkey: str) -> Annotation:
            ann = ann_cache.get(nkey)
            if ann is None:
                ann = ann_cache[nkey] = self[nkey]
            return ann

        use_boxpoint = from_mode == "boxpoint" or (
            from_mode == "poly" and geometry_predicate == "centers_within_k"
        )
        for key, ann in centers.items():
            qx0, qy0, qx1, qy1 = ann.geometry.bounds
            if use_boxpoint:
                qcx, qcy = (qx0 + qx1) / 2, (qy0 + qy1) / 2
                hit = (cand_cx - qcx) ** 2 + (cand_cy - qcy) ** 2 <= distance**2
                exact = False
            else:
                hit = (
                    (boxes[:, 0] <= qx1 + distance)
                    & (boxes[:, 2] >= qx0 - distance)
                    & (boxes[:, 1] <= qy1 + distance)
                    & (boxes[:, 3] >= qy0 - distance)
                )
                exact = from_mode == "poly"
            neighbours = {}
            for idx in np.nonzero(hit)[0]:
                nkey = cand_keys[idx]
                if nkey == key:
                    continue
                if exact and not (
                    ann.geometry.distance(_ann(nkey).geometry) <= distance
                ):
                    continue
                neighbours[nkey] = _ann(nkey)
            if neighbours:
                result[key] = neighbours
        return result

    # -- I/O ------------------------------------------------------------------------

    def to_geojson(self, fp=None) -> str | None:
        """Serialize as a GeoJSON FeatureCollection.

        With a file target the features stream out one at a time, so
        peak memory stays O(largest annotation) instead of O(store)
        (the full-string build transiently cost ~6x the serialized
        size on a 10k-annotation store).
        """
        if fp is None:
            collection = {
                "type": "FeatureCollection",
                "features": [ann.to_feature() for ann in self.values()],
            }
            return json.dumps(collection)

        def _write_stream(out) -> None:
            out.write('{"type": "FeatureCollection", "features": [')
            first = True
            for ann in self.values():
                if not first:
                    out.write(", ")
                first = False
                out.write(json.dumps(ann.to_feature()))
            out.write("]}")

        if hasattr(fp, "write"):
            _write_stream(fp)
            return None
        with Path(fp).open("w") as out:
            _write_stream(out)
        return None

    @classmethod
    def from_geojson(cls, fp, scale_factor=(1, 1), origin=(0, 0)) -> "AnnotationStore":
        """Load a store from GeoJSON (file path, file object, or string)."""
        store = cls()
        store.add_from_geojson(fp, scale_factor, origin)
        return store

    def add_from_geojson(self, fp, scale_factor=(1, 1), origin=(0, 0)) -> None:
        if hasattr(fp, "read"):
            data = json.load(fp)
        elif isinstance(fp, str) and fp.lstrip().startswith("{"):
            data = json.loads(fp)
        else:
            data = json.loads(Path(fp).read_text())
        features = data["features"] if data.get("type") == "FeatureCollection" else data
        anns = []
        for feature in features:
            geom = geojson_to_geometry(feature["geometry"])
            # reference semantics (storage.py add_from_geojson): translate
            # to the origin, then scale about (0, 0) — no translate back
            geom = _transform_geometry(
                geom,
                lambda c: (np.asarray(c) - np.asarray(origin))
                * np.asarray(scale_factor),
            )
            anns.append(Annotation(geom, feature.get("properties") or {}))
        self.append_many(anns)

    def to_ndjson(self, fp=None) -> str | None:
        """One GeoJSON feature (with key) per line (streamed to files)."""

        def _lines():
            for key, ann in self.items():
                feature = ann.to_feature()
                feature["key"] = key
                yield json.dumps(feature) + "\n"

        if fp is None:
            return "".join(_lines())
        if hasattr(fp, "write"):
            for line in _lines():
                fp.write(line)
            return None
        with Path(fp).open("w") as out:
            out.writelines(_lines())
        return None

    @classmethod
    def from_ndjson(cls, fp) -> "AnnotationStore":
        store = cls()
        if hasattr(fp, "read"):
            text = fp.read()
        elif isinstance(fp, str) and "\n" in fp:
            text = fp
        else:
            text = Path(fp).read_text()
        for line in text.splitlines():
            if not line.strip():
                continue
            feature = json.loads(line)
            store[feature.get("key", str(uuid.uuid4()))] = Annotation(
                geojson_to_geometry(feature["geometry"]),
                feature.get("properties") or {},
            )
        return store

    def features(self):
        """Generator of GeoJSON feature dicts (reference ``storage.py:1802``)."""
        for ann in self.values():
            yield ann.to_feature()

    def to_geodict(self) -> dict:
        """GeoJSON FeatureCollection dict (reference ``storage.py:1813``)."""
        return {"type": "FeatureCollection", "features": list(self.features())}

    @classmethod
    def from_dataframe(cls, df) -> "AnnotationStore":
        """Build a store from a dataframe with geometry + property columns."""
        store = cls()
        for key, row in df.iterrows():
            row = dict(row)
            geometry = row.pop("geometry")
            if isinstance(geometry, (bytes, bytearray)):
                geometry = wkb_to_geometry(bytes(geometry))
            elif isinstance(geometry, str):
                geometry = wkt_to_geometry(geometry)
            properties = {
                k.removeprefix("properties."): v
                for k, v in row.items()
                if v is not None and v == v  # noqa: PLR0124 - NaN filter
            }
            store[str(key)] = Annotation(geometry, properties)
        return store

    def to_dataframe(self):
        """Annotations as a pandas DataFrame (geometry WKT + properties)."""
        import pandas as pd

        rows = []
        for key, ann in self.items():
            row = {"key": key, "geometry": ann.geometry.to_wkt()}
            row.update({f"properties.{k}": v for k, v in ann.properties.items()})
            rows.append(row)
        return pd.DataFrame(rows).set_index("key") if rows else pd.DataFrame()

    def transform(self, transform) -> None:
        """Apply a coordinate transform fn([N,2])→[N,2] to all geometries."""
        for key, ann in list(self.items()):
            new_geom = _transform_geometry(ann.geometry, transform)
            self[key] = Annotation(new_geom, ann.properties)

    def translate_db(self, x: float, y: float) -> None:
        """Translate all geometries by (x, y)."""
        self.transform(lambda coords: np.asarray(coords) + np.array([x, y]))

    # -- misc ------------------------------------------------------------------------

    def commit(self) -> None:
        """Flush any pending writes (no-op for in-memory)."""

    def close(self) -> None:
        """Release resources."""

    def __del__(self) -> None:
        try:  # noqa: SIM105 - contextlib may be torn down at interpreter exit
            self.close()
        except BaseException:  # noqa: BLE001, S110
            pass


def _transform_geometry(geom: Geometry, transform) -> Geometry:
    from tiatoolbox_tpu_torch.annotation import geometry as G

    if isinstance(geom, Point):
        out = np.asarray(transform(np.array([[geom.x, geom.y]])))
        return Point(out[0])
    if isinstance(geom, G.LineString):
        return G.LineString(transform(geom.coords_array))
    if isinstance(geom, Polygon):
        return Polygon(
            transform(geom.shell), [transform(h) for h in geom.holes]
        )
    if isinstance(geom, G._Multi):  # noqa: SLF001
        return type(geom)([_transform_geometry(g, transform) for g in geom.geoms])
    msg = f"Cannot transform geometry type {type(geom)}"
    raise TypeError(msg)


class DictionaryStore(AnnotationStore):
    """In-memory dict-backed store (reference ``storage.py:3965-4128``)."""

    def __init__(self, connection=":memory:") -> None:
        super().__init__()
        self._rows: dict[str, Annotation] = {}
        self.connection = connection
        self.path = None if connection == ":memory:" else Path(connection)
        if self.path and self.path.exists() and self.path.stat().st_size > 0:
            self.add_from_geojson(self.path)

    def __getitem__(self, key: str) -> Annotation:
        return self._rows[key]

    def __setitem__(self, key: str, annotation: Annotation) -> None:
        if not isinstance(annotation, Annotation):
            msg = "Value must be an Annotation instance."
            raise TypeError(msg)
        self._rows[key] = annotation

    def __delitem__(self, key: str) -> None:
        del self._rows[key]

    def __iter__(self):
        return iter(self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    def commit(self) -> None:
        if self.path is not None:
            self.to_geojson(self.path)

    def dump(self, fp) -> None:
        self.to_geojson(fp)

    def dumps(self) -> str:
        return self.to_geojson()


class SQLiteStore(AnnotationStore):
    """SQLite-backed store with an R*Tree spatial index.

    Schema (mirrors reference ``storage.py:2310-2644``): an
    ``annotations`` table (key, geometry as zlib-WKB blob, centroid,
    area, properties JSON) plus an ``rtree`` virtual table over the
    bounding boxes, joined by rowid. Python helper functions (REGEXP,
    LISTSUM, CONTAINS) are registered per connection so DSL-compiled
    WHERE clauses run inside SQLite.
    """

    @classmethod
    def compile_options(cls) -> list[str]:
        con = sqlite3.connect(":memory:")
        opts = [row[0] for row in con.execute("PRAGMA compile_options").fetchall()]
        con.close()
        return opts

    def __init__(self, connection=":memory:", auto_commit: bool = True) -> None:
        super().__init__()
        self.connection = connection
        self.path = None if str(connection) == ":memory:" else Path(connection)
        self.auto_commit = auto_commit
        self._local = threading.local()
        self.metadata = _SQLiteMetadata(self)
        con = self.con
        con.executescript(
            """
            CREATE TABLE IF NOT EXISTS annotations (
                id INTEGER PRIMARY KEY,
                key TEXT UNIQUE NOT NULL,
                objtype TEXT,
                cx REAL,
                cy REAL,
                area REAL,
                geometry BLOB,
                properties TEXT
            );
            CREATE VIRTUAL TABLE IF NOT EXISTS rtree USING rtree(
                id, min_x, max_x, min_y, max_y
            );
            CREATE TABLE IF NOT EXISTS metadata (
                key TEXT PRIMARY KEY, value TEXT
            );
            CREATE INDEX IF NOT EXISTS annotation_key ON annotations(key);
            """
        )
        con.commit()
        # honor the reference's on-disk metadata contract
        # (``storage.py:2384-2393``): geometry compression is declared
        # in the metadata table, so .db files interoperate both ways —
        # a reference-written store (compression "zlib" or None) opens
        # here, and stores written here carry the keys the reference
        # reads on open.
        compression = self.metadata.get("compression", "__absent__")
        if compression == "__absent__":
            self.metadata["version"] = "1.0.1"
            self.metadata["compression"] = "zlib"
            self.metadata["compression_level"] = ZLIB_LEVEL
            compression = "zlib"
        self._compression = compression
        level = self.metadata.get("compression_level", ZLIB_LEVEL)
        self._compression_level = level if isinstance(level, int) else ZLIB_LEVEL

    # -- connections ----------------------------------------------------------------

    @property
    def con(self) -> sqlite3.Connection:
        """Per-thread connection (reference ``storage.py:2436``)."""
        con = getattr(self._local, "con", None)
        if con is None:
            target = str(self.connection)
            if self.path is not None:
                con = sqlite3.connect(str(self.path), timeout=30)
            elif target == ":memory:":
                # unique named in-memory db, shareable across this
                # store's threads but isolated from other stores
                con = sqlite3.connect(
                    f"file:memdb_{id(self)}?mode=memory&cache=shared",
                    uri=True,
                    check_same_thread=False,
                )
                # keep one anchor connection alive so the db persists
                if not hasattr(self, "_memory_anchor"):
                    self._memory_anchor = con
            else:
                con = sqlite3.connect(target, timeout=30)
            self._register_functions(con)
            self._local.con = con
        return con

    def _register_functions(self, con: sqlite3.Connection) -> None:
        # returns the matched substring or NULL — same contract as the
        # python-mode regexp helper, so is_none/is_not_none and truthiness
        # agree between backends (reference registers the match this way)
        con.create_function("REGEXP", 2, lambda p, s: dsl.py_regexp(p, str(s)))
        con.create_function(
            "REGEXP", 3, lambda p, s, f: dsl.py_regexp(p, str(s), int(f))
        )
        con.create_function("LISTSUM", 1, dsl.json_list_sum)
        con.create_function("CONTAINS", 2, dsl.json_contains)
        con.create_function(
            "GET_AREA", 1, lambda blob: self._unpack_geometry(blob).area
        )
        # python truthiness in one evaluation (NULL/0/'' are falsy;
        # non-empty strings truthy — strings never equal numbers here)
        con.create_function(
            "TRUTHY", 1, lambda v: int(v is not None and v != 0 and v != "")
        )

    # -- serialization -----------------------------------------------------------------

    def _pack_geometry(self, geometry: Geometry) -> bytes:
        wkb = geometry.to_wkb()
        if self._compression == "zlib":
            return zlib.compress(wkb, self._compression_level)
        return wkb

    def _unpack_geometry(self, blob: bytes) -> Geometry:
        if self._compression == "zlib":
            return wkb_to_geometry(zlib.decompress(blob))
        return wkb_to_geometry(blob)

    # -- mapping interface -----------------------------------------------------------

    def __setitem__(self, key: str, annotation: Annotation) -> None:
        if not isinstance(annotation, Annotation):
            msg = "Value must be an Annotation instance."
            raise TypeError(msg)
        geom = annotation.geometry
        bounds = geom.bounds
        centroid = geom.centroid
        con = self.con
        with con:
            cur = con.execute("SELECT id FROM annotations WHERE key = ?", (key,))
            row = cur.fetchone()
            if row is not None:
                row_id = row[0]
                con.execute(
                    "UPDATE annotations SET objtype=?, cx=?, cy=?, area=?, "
                    "geometry=?, properties=? WHERE id=?",
                    (
                        geom.geom_type,
                        centroid.x,
                        centroid.y,
                        geom.area,
                        self._pack_geometry(geom),
                        json.dumps(annotation.properties),
                        row_id,
                    ),
                )
                con.execute(
                    "UPDATE rtree SET min_x=?, max_x=?, min_y=?, max_y=? WHERE id=?",
                    (bounds[0], bounds[2], bounds[1], bounds[3], row_id),
                )
            else:
                cur = con.execute(
                    "INSERT INTO annotations "
                    "(key, objtype, cx, cy, area, geometry, properties) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?)",
                    (
                        key,
                        geom.geom_type,
                        centroid.x,
                        centroid.y,
                        geom.area,
                        self._pack_geometry(geom),
                        json.dumps(annotation.properties),
                    ),
                )
                con.execute(
                    "INSERT INTO rtree (id, min_x, max_x, min_y, max_y) "
                    "VALUES (?, ?, ?, ?, ?)",
                    (cur.lastrowid, bounds[0], bounds[2], bounds[1], bounds[3]),
                )

    def __getitem__(self, key: str) -> Annotation:
        cur = self.con.execute(
            "SELECT geometry, properties FROM annotations WHERE key = ?", (key,)
        )
        row = cur.fetchone()
        if row is None:
            raise KeyError(key)
        return Annotation(self._unpack_geometry(row[0]), json.loads(row[1]))

    def __delitem__(self, key: str) -> None:
        con = self.con
        with con:
            cur = con.execute("SELECT id FROM annotations WHERE key = ?", (key,))
            row = cur.fetchone()
            if row is None:
                raise KeyError(key)
            con.execute("DELETE FROM annotations WHERE id = ?", (row[0],))
            con.execute("DELETE FROM rtree WHERE id = ?", (row[0],))

    def __iter__(self):
        cur = self.con.execute("SELECT key FROM annotations ORDER BY id")
        for (key,) in cur:
            yield key

    def __len__(self) -> int:
        return self.con.execute("SELECT COUNT(*) FROM annotations").fetchone()[0]

    # -- optimised bulk + queries ---------------------------------------------------------

    def append_many(self, annotations, keys=None) -> list[str]:
        annotations = list(annotations)
        if keys is None:
            keys = [str(uuid.uuid4()) for _ in annotations]
        keys = list(keys)
        if len(keys) != len(annotations):
            msg = "Number of keys must match number of annotations."
            raise ValueError(msg)
        con = self.con
        with con:
            # the ids SQLite would give one insert at a time (the largest
            # rowid plus one), so the rows and their boxes go in two batches
            (first_id,) = con.execute("SELECT COALESCE(MAX(id), 0) + 1 FROM annotations").fetchone()
            rows, boxes = [], []
            for row_id, (key, ann) in enumerate(zip(keys, annotations), start=first_id):
                geom = ann.geometry
                bounds = geom.bounds
                centroid = geom.centroid
                rows.append(
                    (
                        row_id,
                        key,
                        geom.geom_type,
                        centroid.x,
                        centroid.y,
                        geom.area,
                        self._pack_geometry(geom),
                        json.dumps(ann.properties),
                    )
                )
                boxes.append((row_id, bounds[0], bounds[2], bounds[1], bounds[3]))
            con.executemany(
                "INSERT INTO annotations "
                "(id, key, objtype, cx, cy, area, geometry, properties) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                rows,
            )
            con.executemany(
                "INSERT INTO rtree (id, min_x, max_x, min_y, max_y) VALUES (?, ?, ?, ?, ?)",
                boxes,
            )
        return keys

    def _compile_where(self, where) -> tuple[str, bool]:
        """Compile a where predicate to SQL; returns (clause, post_filter)."""
        if where is None:
            return "", False
        if callable(where):
            return "", True
        try:
            fragment = eval(  # noqa: S307
                where, dict(dsl.SQL_GLOBALS), {}
            )
            # python-truthiness at the boundary via the TRUTHY UDF
            # (NULL / 0 / '' falsy): evaluates the compiled fragment —
            # which may invoke python UDFs like REGEXP — exactly ONCE
            # per row
            return f"AND TRUTHY(({fragment}))", False
        except Exception:  # fall back to python filtering
            logger.warning("Could not compile where to SQL; filtering in Python.")
            return "", True

    def _candidates(self, geometry, where):
        """Rows whose bbox intersects the query geometry, SQL-filtered."""
        sql = (
            "SELECT annotations.key, annotations.geometry, annotations.properties "
            "FROM annotations, rtree WHERE annotations.id = rtree.id "
        )
        params: list = []
        if geometry is not None:
            query_geom = _to_geometry(geometry)
            x0, y0, x1, y1 = query_geom.bounds
            sql += "AND rtree.max_x >= ? AND rtree.min_x <= ? AND rtree.max_y >= ? AND rtree.min_y <= ? "
            params += [x0, x1, y0, y1]
        clause, post_filter = ("", True) if callable(where) else self._compile_where(where)
        if clause:
            sql += clause
        cur = self.con.execute(sql, params)
        for key, blob, props_json in cur:
            props = json.loads(props_json)
            if post_filter and not self._eval_where(where, props):
                continue
            yield key, blob, props

    def query(
        self,
        geometry=None,
        where=None,
        geometry_predicate: str = "intersects",
        min_area: float | None = None,
        distance: float = 0,
    ) -> dict[str, Annotation]:
        if geometry is None and where is None:
            msg = "At least one of geometry or where must be provided."
            raise ValueError(msg)
        query_geom = _to_geometry(geometry) if geometry is not None else None
        if query_geom is not None and distance > 0:
            query_geom = query_geom.buffer(distance)
        predicate = self._geometry_predicate(geometry_predicate)
        result = {}
        for key, blob, props in self._candidates(
            query_geom.bounds if query_geom else None, where
        ):
            geom = self._unpack_geometry(blob)
            if min_area is not None and geom.area < min_area:
                continue
            if query_geom is not None and not predicate(geom, query_geom):
                continue
            result[key] = Annotation(geom, props)
        return result

    def bquery(self, geometry=None, where=None) -> dict[str, tuple]:
        sql = (
            "SELECT annotations.key, rtree.min_x, rtree.min_y, rtree.max_x, "
            "rtree.max_y, annotations.properties "
            "FROM annotations, rtree WHERE annotations.id = rtree.id "
        )
        params: list = []
        if geometry is not None:
            query_geom = _to_geometry(geometry)
            x0, y0, x1, y1 = query_geom.bounds
            sql += "AND rtree.max_x >= ? AND rtree.min_x <= ? AND rtree.max_y >= ? AND rtree.min_y <= ? "
            params += [x0, x1, y0, y1]
        clause, post_filter = ("", True) if callable(where) else self._compile_where(where)
        if clause:
            sql += clause
        result = {}
        for key, min_x, min_y, max_x, max_y, props_json in self.con.execute(sql, params):
            if post_filter and not self._eval_where(where, json.loads(props_json)):
                continue
            result[key] = (min_x, min_y, max_x, max_y)
        return result

    # -- persistence ----------------------------------------------------------------------

    def commit(self) -> None:
        self.con.commit()

    def close(self) -> None:
        con = getattr(self._local, "con", None)
        if con is not None:
            with contextlib.suppress(sqlite3.ProgrammingError):
                con.commit()
                con.close()
            self._local.con = None

    def dump(self, fp) -> None:
        """Write the database to a file path or file object."""
        if hasattr(fp, "write"):
            fp.write(self.dumps().encode() if "b" in getattr(fp, "mode", "b") else self.dumps())
            return
        target = sqlite3.connect(str(fp))
        with target:
            self.con.backup(target)
        target.close()

    def dumps(self) -> str:
        return "\n".join(self.con.iterdump())

    def create_index(self, name: str, where: str) -> None:
        """Create a partial/expression index from a DSL predicate."""
        fragment = eval(where, dict(dsl.SQL_GLOBALS), {})  # noqa: S307
        self.con.execute(
            f"CREATE INDEX IF NOT EXISTS {name} ON annotations({fragment})"
        )
        self.con.commit()

    def indexes(self) -> list[str]:
        return [
            row[0]
            for row in self.con.execute(
                "SELECT name FROM sqlite_master WHERE type = 'index'"
            )
        ]

    def drop_index(self, name: str) -> None:
        """Drop an index created with ``create_index``.

        Raises KeyError when no such index exists (reference behavior).
        """
        exists = self.con.execute(
            "SELECT 1 FROM sqlite_master WHERE type = 'index' AND name = ?",
            (name,),
        ).fetchone()
        if exists is None:
            msg = f"No such index: {name}"
            raise KeyError(msg)
        self.con.execute(f"DROP INDEX {name}")
        self.con.commit()

    def add_area_column(self, *, mk_index: bool = True) -> None:
        """Reference-API shim: this schema always stores ``area``
        (reference ``storage.py:3780`` adds it lazily); optionally
        index it."""
        if mk_index and "area" not in self.indexes():
            self.create_index("area", '"area"')

    def remove_area_column(self) -> None:
        """Reference-API shim: drops the area index (the column is part
        of this schema and kept)."""
        if "area" in self.indexes():
            self.drop_index("area")

    def optimize(self, *, vacuum: bool = True) -> None:
        if vacuum:
            self.con.execute("VACUUM")
        self.con.execute("PRAGMA optimize")


class _SQLiteMetadata(MutableMapping):
    """Metadata key/value table on an SQLiteStore (public alias:
    :class:`SQLiteMetadata`, reference ``storage.py:2249``)."""

    def __init__(self, store: SQLiteStore) -> None:
        self._store = store

    def __getitem__(self, key: str):
        row = self._store.con.execute(
            "SELECT value FROM metadata WHERE key = ?", (key,)
        ).fetchone()
        if row is None:
            raise KeyError(key)
        return json.loads(row[0])

    def __setitem__(self, key: str, value) -> None:
        con = self._store.con
        with con:
            con.execute(
                "INSERT OR REPLACE INTO metadata (key, value) VALUES (?, ?)",
                (key, json.dumps(value)),
            )

    def __delitem__(self, key: str) -> None:
        con = self._store.con
        with con:
            cur = con.execute("DELETE FROM metadata WHERE key = ?", (key,))
            if cur.rowcount == 0:
                raise KeyError(key)

    def __iter__(self):
        for (key,) in self._store.con.execute("SELECT key FROM metadata"):
            yield key

    def __len__(self) -> int:
        return self._store.con.execute("SELECT COUNT(*) FROM metadata").fetchone()[0]


# public alias for API parity with the reference (``storage.py:2249``)
SQLiteMetadata = _SQLiteMetadata
