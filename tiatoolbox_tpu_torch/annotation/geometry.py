"""2-D geometry (counterpart of ``tiatoolbox_tpu/annotation/geometry.py:1-797``).

WKB/WKT/GeoJSON codecs and predicates, the same bytes and text as JAX's.

Replaces Shapely/GEOS (absent from this build) for the annotation
store's needs: bounds, area, centroid, point-in-polygon, bbox and
geometry intersection tests, buffering of points (for queries), and
the WKB wire format used by the SQLite backend (reference stores
zlib-compressed WKB — ``annotation/storage.py:2620``).

Coordinates are numpy float64 arrays of shape [N, 2]; everything is
vectorised where the math allows.
"""

from __future__ import annotations

import json
import math
import struct

import numpy as np

# WKB geometry type codes (little-endian byte order used throughout).
WKB_POINT = 1
WKB_LINESTRING = 2
WKB_POLYGON = 3
WKB_MULTIPOINT = 4
WKB_MULTILINESTRING = 5
WKB_MULTIPOLYGON = 6
WKB_GEOMETRYCOLLECTION = 7


class Geometry:
    """Base geometry. Subclasses: Point, LineString, Polygon, Multi*."""

    geom_type = "Geometry"

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        raise NotImplementedError

    @property
    def area(self) -> float:
        return 0.0

    @property
    def length(self) -> float:
        return 0.0

    @property
    def centroid(self) -> "Point":
        raise NotImplementedError

    def to_wkb(self) -> bytes:
        raise NotImplementedError

    def to_wkt(self) -> str:
        raise NotImplementedError

    def to_geojson_dict(self) -> dict:
        raise NotImplementedError

    # -- predicates -------------------------------------------------------------

    def bbox_intersects(self, other: "Geometry") -> bool:
        a = self.bounds
        b = other.bounds
        return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])

    def intersects(self, other: "Geometry") -> bool:
        return geometry_intersects(self, other)

    def contains(self, other: "Geometry") -> bool:
        return geometry_contains(self, other)

    def within(self, other: "Geometry") -> bool:
        return geometry_contains(other, self)

    def distance(self, other: "Geometry") -> float:
        return geometry_distance(self, other)

    def buffer(self, radius: float, resolution: int = 16) -> "Polygon":
        """Approximate buffer: circle for points, bbox expansion otherwise."""
        if isinstance(self, Point):
            angles = np.linspace(0, 2 * math.pi, 4 * resolution, endpoint=False)
            ring = np.stack(
                [self.x + radius * np.cos(angles), self.y + radius * np.sin(angles)],
                axis=-1,
            )
            return Polygon(ring)
        x0, y0, x1, y1 = self.bounds
        return Polygon(
            [
                (x0 - radius, y0 - radius),
                (x1 + radius, y0 - radius),
                (x1 + radius, y1 + radius),
                (x0 - radius, y1 + radius),
            ]
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Geometry):
            return NotImplemented
        return self.to_wkb() == other.to_wkb()

    def __hash__(self) -> int:
        return hash(self.to_wkb())

    def __repr__(self) -> str:
        return self.to_wkt()


class Point(Geometry):
    """A 2-D point."""

    geom_type = "Point"

    def __init__(self, x, y=None) -> None:
        if y is None:
            x, y = x
        self.x = float(x)
        self.y = float(y)

    @property
    def coords(self) -> np.ndarray:
        return np.array([[self.x, self.y]])

    @property
    def bounds(self) -> tuple:
        return (self.x, self.y, self.x, self.y)

    @property
    def centroid(self) -> "Point":
        return self

    def to_wkb(self) -> bytes:
        return struct.pack("<BIdd", 1, WKB_POINT, self.x, self.y)

    def to_wkt(self) -> str:
        return f"POINT ({_fmt(self.x)} {_fmt(self.y)})"

    def to_geojson_dict(self) -> dict:
        return {"type": "Point", "coordinates": [self.x, self.y]}


class LineString(Geometry):
    """An open polyline of 2-D points."""

    geom_type = "LineString"

    def __init__(self, coords) -> None:
        self.coords_array = np.asarray(coords, dtype=np.float64).reshape(-1, 2)
        if len(self.coords_array) < 2:
            msg = "LineString requires at least 2 points."
            raise ValueError(msg)

    @property
    def coords(self) -> np.ndarray:
        return self.coords_array

    @property
    def bounds(self) -> tuple:
        mins = self.coords_array.min(axis=0)
        maxs = self.coords_array.max(axis=0)
        return (mins[0], mins[1], maxs[0], maxs[1])

    @property
    def length(self) -> float:
        diffs = np.diff(self.coords_array, axis=0)
        return float(np.hypot(diffs[:, 0], diffs[:, 1]).sum())

    @property
    def centroid(self) -> Point:
        # length-weighted midpoint average
        p = self.coords_array
        diffs = np.diff(p, axis=0)
        seg_len = np.hypot(diffs[:, 0], diffs[:, 1])
        mids = (p[:-1] + p[1:]) / 2
        total = seg_len.sum()
        if total == 0:
            return Point(p[0])
        c = (mids * seg_len[:, None]).sum(axis=0) / total
        return Point(c)

    def to_wkb(self) -> bytes:
        n = len(self.coords_array)
        return (
            struct.pack("<BII", 1, WKB_LINESTRING, n)
            + self.coords_array.astype("<f8").tobytes()
        )

    def to_wkt(self) -> str:
        pts = ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in self.coords_array)
        return f"LINESTRING ({pts})"

    def to_geojson_dict(self) -> dict:
        return {"type": "LineString", "coordinates": self.coords_array.tolist()}


class Polygon(Geometry):
    """A polygon with an exterior shell and optional holes."""

    geom_type = "Polygon"

    def __init__(self, shell, holes=None) -> None:
        shell = np.asarray(shell, dtype=np.float64).reshape(-1, 2)
        if len(shell) and not np.array_equal(shell[0], shell[-1]):
            shell = np.vstack([shell, shell[:1]])
        if len(shell) < 4:
            msg = "Polygon shell requires at least 3 distinct points."
            raise ValueError(msg)
        self.shell = shell
        self.holes = []
        for h in holes or []:
            h = np.asarray(h, dtype=np.float64).reshape(-1, 2)
            if len(h) and not np.array_equal(h[0], h[-1]):
                h = np.vstack([h, h[:1]])
            self.holes.append(h)

    @property
    def exterior(self) -> LineString:
        return LineString(self.shell)

    @property
    def coords(self) -> np.ndarray:
        return self.shell

    @property
    def bounds(self) -> tuple:
        mins = self.shell.min(axis=0)
        maxs = self.shell.max(axis=0)
        return (mins[0], mins[1], maxs[0], maxs[1])

    @staticmethod
    def _ring_area(ring: np.ndarray) -> float:
        x, y = ring[:, 0], ring[:, 1]
        return 0.5 * float(np.dot(x[:-1], y[1:]) - np.dot(x[1:], y[:-1]))

    @property
    def area(self) -> float:
        area = abs(self._ring_area(self.shell))
        for h in self.holes:
            area -= abs(self._ring_area(h))
        return area

    @property
    def length(self) -> float:
        return LineString(self.shell).length

    @property
    def centroid(self) -> Point:
        ring = self.shell
        a = self._ring_area(ring)
        if a == 0:
            return Point(ring[:-1].mean(axis=0))
        x, y = ring[:, 0], ring[:, 1]
        cross = x[:-1] * y[1:] - x[1:] * y[:-1]
        cx = float(((x[:-1] + x[1:]) * cross).sum() / (6 * a))
        cy = float(((y[:-1] + y[1:]) * cross).sum() / (6 * a))
        return Point(cx, cy)

    def contains_point(self, x: float, y: float) -> bool:
        if not _point_in_ring(self.shell, x, y):
            return False
        return all(not _point_in_ring(h, x, y) for h in self.holes)

    def to_wkb(self) -> bytes:
        rings = [self.shell, *self.holes]
        # one join: adding each ring to the bytes so far is quadratic in holes
        parts = [struct.pack("<BII", 1, WKB_POLYGON, len(rings))]
        for ring in rings:
            parts += (struct.pack("<I", len(ring)), ring.astype("<f8").tobytes())
        return b"".join(parts)

    def to_wkt(self) -> str:
        def ring_str(ring):
            return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in ring) + ")"

        rings = ", ".join(ring_str(r) for r in [self.shell, *self.holes])
        return f"POLYGON ({rings})"

    def to_geojson_dict(self) -> dict:
        return {
            "type": "Polygon",
            "coordinates": [self.shell.tolist()]
            + [h.tolist() for h in self.holes],
        }

    @classmethod
    def from_bounds(cls, x0, y0, x1, y1) -> "Polygon":
        return cls([(x0, y0), (x1, y0), (x1, y1), (x0, y1)])


class _Multi(Geometry):
    """Base for homogeneous multi-geometries."""

    member_type: type = Geometry
    wkb_code = WKB_GEOMETRYCOLLECTION

    def __init__(self, geoms) -> None:
        self.geoms = [
            g if isinstance(g, self.member_type) else self.member_type(g)
            for g in geoms
        ]

    @property
    def bounds(self) -> tuple:
        bs = np.array([g.bounds for g in self.geoms])
        return (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())

    @property
    def coords(self) -> np.ndarray:
        """Member coordinate arrays stacked along axis 0."""
        return np.concatenate([np.atleast_2d(g.coords) for g in self.geoms], axis=0)

    @property
    def area(self) -> float:
        return sum(g.area for g in self.geoms)

    @property
    def length(self) -> float:
        return sum(g.length for g in self.geoms)

    @property
    def centroid(self) -> Point:
        cs = np.array([[g.centroid.x, g.centroid.y] for g in self.geoms])
        weights = np.array([max(g.area, 1e-12) for g in self.geoms])
        c = (cs * weights[:, None]).sum(axis=0) / weights.sum()
        return Point(c)

    def to_wkb(self) -> bytes:
        out = struct.pack("<BII", 1, self.wkb_code, len(self.geoms))
        return out + b"".join(g.to_wkb() for g in self.geoms)

    def to_wkt(self) -> str:
        name = self.geom_type.upper()
        inner = ", ".join(
            g.to_wkt().split(" ", 1)[1] for g in self.geoms
        )
        return f"{name} ({inner})"

    def to_geojson_dict(self) -> dict:
        return {
            "type": self.geom_type,
            "coordinates": [g.to_geojson_dict()["coordinates"] for g in self.geoms],
        }


class MultiPoint(_Multi):
    """A collection of points."""

    geom_type = "MultiPoint"
    member_type = Point
    wkb_code = WKB_MULTIPOINT


class MultiLineString(_Multi):
    """A collection of polylines."""

    geom_type = "MultiLineString"
    member_type = LineString
    wkb_code = WKB_MULTILINESTRING


class MultiPolygon(_Multi):
    """A collection of polygons."""

    geom_type = "MultiPolygon"
    member_type = Polygon
    wkb_code = WKB_MULTIPOLYGON


class GeometryCollection(_Multi):
    """A heterogeneous collection of geometries (WKB type 7).

    Shapely/GEOS stores can hold these (e.g. an intersection result
    persisted by the reference), so the codecs round-trip them even
    though no first-party tool produces them.
    """

    geom_type = "GeometryCollection"
    member_type = Geometry
    wkb_code = WKB_GEOMETRYCOLLECTION

    def __init__(self, geoms) -> None:
        geoms = list(geoms)
        for g in geoms:
            if not isinstance(g, Geometry):
                msg = "GeometryCollection members must be Geometry instances."
                raise TypeError(msg)
        self.geoms = geoms

    def to_wkt(self) -> str:
        # members keep their own type names (unlike homogeneous multis)
        inner = ", ".join(g.to_wkt() for g in self.geoms)
        return f"GEOMETRYCOLLECTION ({inner})" if self.geoms else (
            "GEOMETRYCOLLECTION EMPTY"
        )

    def to_geojson_dict(self) -> dict:
        return {
            "type": "GeometryCollection",
            "geometries": [g.to_geojson_dict() for g in self.geoms],
        }


def _fmt(v: float) -> str:
    return f"{v:.10g}"


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


def _point_in_ring(ring: np.ndarray, x: float, y: float) -> bool:
    """Even-odd rule point-in-ring test (boundary counts as inside)."""
    xs, ys = ring[:, 0], ring[:, 1]
    x0, y0 = xs[:-1], ys[:-1]
    x1, y1 = xs[1:], ys[1:]
    # boundary check: point on any segment
    dx, dy = x1 - x0, y1 - y0
    px, py = x - x0, y - y0
    cross = dx * py - dy * px
    dot = px * dx + py * dy
    seg_len2 = dx * dx + dy * dy
    on_edge = (np.abs(cross) < 1e-9) & (dot >= -1e-9) & (dot <= seg_len2 + 1e-9)
    if np.any(on_edge):
        return True
    crossing = ((y0 > y) != (y1 > y)) & (
        x < (x1 - x0) * (y - y0) / np.where(y1 != y0, y1 - y0, 1e-300) + x0
    )
    return bool(np.count_nonzero(crossing) % 2)


def _segments_intersect(a0, a1, b0, b1) -> bool:
    def orient(p, q, r):
        return (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])

    d1 = orient(b0, b1, a0)
    d2 = orient(b0, b1, a1)
    d3 = orient(a0, a1, b0)
    d4 = orient(a0, a1, b1)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True

    def on_seg(p, q, r):
        return (
            min(p[0], q[0]) - 1e-12 <= r[0] <= max(p[0], q[0]) + 1e-12
            and min(p[1], q[1]) - 1e-12 <= r[1] <= max(p[1], q[1]) + 1e-12
        )

    if abs(d1) < 1e-12 and on_seg(b0, b1, a0):
        return True
    if abs(d2) < 1e-12 and on_seg(b0, b1, a1):
        return True
    if abs(d3) < 1e-12 and on_seg(a0, a1, b0):
        return True
    return bool(abs(d4) < 1e-12 and on_seg(a0, a1, b1))


def _polylines_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Any segment of polyline a intersects any segment of polyline b."""
    # bbox prefilter per segment for speed on large polygons
    for i in range(len(a) - 1):
        a0, a1 = a[i], a[i + 1]
        lo = np.minimum(a0, a1)
        hi = np.maximum(a0, a1)
        b0s, b1s = b[:-1], b[1:]
        blo = np.minimum(b0s, b1s)
        bhi = np.maximum(b0s, b1s)
        cand = ~(
            (bhi[:, 0] < lo[0])
            | (blo[:, 0] > hi[0])
            | (bhi[:, 1] < lo[1])
            | (blo[:, 1] > hi[1])
        )
        for j in np.nonzero(cand)[0]:
            if _segments_intersect(a0, a1, b0s[j], b1s[j]):
                return True
    return False


def _as_parts(geom: Geometry) -> list[Geometry]:
    if isinstance(geom, _Multi):
        return geom.geoms
    return [geom]


def _simple_intersects(a: Geometry, b: Geometry) -> bool:
    if not a.bbox_intersects(b):
        return False
    if isinstance(a, Point) and isinstance(b, Point):
        return abs(a.x - b.x) < 1e-12 and abs(a.y - b.y) < 1e-12
    if isinstance(a, Point):
        return _simple_intersects(b, a)
    if isinstance(b, Point):
        if isinstance(a, Polygon):
            return a.contains_point(b.x, b.y)
        # point on linestring
        return _point_near_polyline(a.coords, b.x, b.y)
    a_line = a.shell if isinstance(a, Polygon) else a.coords
    b_line = b.shell if isinstance(b, Polygon) else b.coords
    if _polylines_intersect(a_line, b_line):
        return True
    # containment cases
    if isinstance(a, Polygon) and a.contains_point(*b_line[0]):
        return True
    return bool(isinstance(b, Polygon) and b.contains_point(*a_line[0]))


def _point_near_polyline(line: np.ndarray, x: float, y: float, tol=1e-9) -> bool:
    p0, p1 = line[:-1], line[1:]
    d = p1 - p0
    seg_len2 = (d**2).sum(axis=1)
    t = np.clip(
        ((np.array([x, y]) - p0) * d).sum(axis=1) / np.where(seg_len2 > 0, seg_len2, 1),
        0,
        1,
    )
    proj = p0 + t[:, None] * d
    dist2 = ((proj - np.array([x, y])) ** 2).sum(axis=1)
    return bool((dist2 < tol).any())


def geometry_intersects(a: Geometry, b: Geometry) -> bool:
    """True when geometries share any point (multi-aware)."""
    return any(
        _simple_intersects(pa, pb) for pa in _as_parts(a) for pb in _as_parts(b)
    )


def geometry_contains(a: Geometry, b: Geometry) -> bool:
    """True when a fully contains b (vertex containment, no edge crossing)."""
    if not isinstance(a, (Polygon, MultiPolygon)):
        return False
    for pb in _as_parts(b):
        points = pb.coords if not isinstance(pb, Point) else pb.coords
        contained = False
        for pa in _as_parts(a):
            assert isinstance(pa, Polygon)
            if all(pa.contains_point(x, y) for x, y in points):
                if not isinstance(pb, Point):
                    line = pb.shell if isinstance(pb, Polygon) else pb.coords
                    if _polylines_intersect(pa.shell, line):
                        # touching boundary still counts as contains here
                        pass
                contained = True
                break
        if not contained:
            return False
    return True


def geometry_distance(a: Geometry, b: Geometry) -> float:
    """Minimum distance between geometries (0 when intersecting)."""
    if geometry_intersects(a, b):
        return 0.0

    def pts_of(g: Geometry) -> np.ndarray:
        parts = _as_parts(g)
        return np.vstack(
            [p.shell if isinstance(p, Polygon) else p.coords for p in parts]
        )

    pa, pb = pts_of(a), pts_of(b)
    return float(
        np.sqrt(
            min(_min_dist2_pts_to_polyline(pa, pb),
                _min_dist2_pts_to_polyline(pb, pa))
        )
    )


def _min_dist2_pts_to_polyline(pts: np.ndarray, line: np.ndarray) -> float:
    """Min squared distance from any of ``pts`` [P,2] to polyline [S+1,2].

    Vectorized point-to-segment projection, evaluated in point blocks
    so the [P_blk, S, 2] temporaries stay bounded (~64 MB) even for
    region-scale contours with tens of thousands of vertices each —
    the fully-materialized [P, S] form would need O(P*S) memory.
    """
    if len(line) == 1:
        return float(((pts - line[0]) ** 2).sum(axis=1).min())
    p0, p1 = line[:-1], line[1:]  # [S,2]
    d = p1 - p0
    seg_len2 = np.where((d**2).sum(axis=1) > 0, (d**2).sum(axis=1), 1)  # [S]
    block = max(1, int(4_000_000 // max(len(p0), 1)))
    best = np.inf
    for s in range(0, len(pts), block):
        pb = pts[s : s + block]
        rel = pb[:, None, :] - p0[None, :, :]  # [P_blk,S,2]
        t = np.clip((rel * d[None, :, :]).sum(axis=2) / seg_len2, 0, 1)
        proj = p0[None, :, :] + t[:, :, None] * d[None, :, :]
        best = min(best, float(((pb[:, None, :] - proj) ** 2).sum(axis=2).min()))
    return best


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


def wkb_to_geometry(data: bytes) -> Geometry:
    """Decode (little- or big-endian) WKB to a Geometry."""
    geom, _ = _decode_wkb(data, 0)
    return geom


def _decode_wkb(data: bytes, offset: int) -> tuple[Geometry, int]:
    byte_order = data[offset]
    bo = "<" if byte_order == 1 else ">"
    (geom_type,) = struct.unpack_from(bo + "I", data, offset + 1)
    offset += 5
    geom_type &= 0xFF  # mask SRID/dimension flags
    if geom_type == WKB_POINT:
        x, y = struct.unpack_from(bo + "dd", data, offset)
        return Point(x, y), offset + 16
    if geom_type == WKB_LINESTRING:
        (n,) = struct.unpack_from(bo + "I", data, offset)
        offset += 4
        coords = np.frombuffer(data, dtype=bo + "f8", count=2 * n, offset=offset)
        return LineString(coords.reshape(-1, 2)), offset + 16 * n
    if geom_type == WKB_POLYGON:
        (n_rings,) = struct.unpack_from(bo + "I", data, offset)
        offset += 4
        rings = []
        for _ in range(n_rings):
            (n,) = struct.unpack_from(bo + "I", data, offset)
            offset += 4
            coords = np.frombuffer(data, dtype=bo + "f8", count=2 * n, offset=offset)
            rings.append(coords.reshape(-1, 2))
            offset += 16 * n
        return Polygon(rings[0], rings[1:]), offset
    if geom_type in (
        WKB_MULTIPOINT,
        WKB_MULTILINESTRING,
        WKB_MULTIPOLYGON,
        WKB_GEOMETRYCOLLECTION,
    ):
        (n,) = struct.unpack_from(bo + "I", data, offset)
        offset += 4
        members = []
        for _ in range(n):
            member, offset = _decode_wkb(data, offset)
            members.append(member)
        cls = {
            WKB_MULTIPOINT: MultiPoint,
            WKB_MULTILINESTRING: MultiLineString,
            WKB_MULTIPOLYGON: MultiPolygon,
            WKB_GEOMETRYCOLLECTION: GeometryCollection,
        }[geom_type]
        return cls(members), offset
    msg = f"Unsupported WKB geometry type: {geom_type}"
    raise ValueError(msg)


def geojson_to_geometry(obj: dict | str) -> Geometry:
    """Decode a GeoJSON geometry dict (or JSON string)."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    gtype = obj["type"]
    if gtype == "GeometryCollection":
        return GeometryCollection(
            [geojson_to_geometry(g) for g in obj["geometries"]]
        )
    coords = obj["coordinates"]
    if gtype == "Point":
        return Point(coords)
    if gtype == "LineString":
        return LineString(coords)
    if gtype == "Polygon":
        return Polygon(coords[0], coords[1:])
    if gtype == "MultiPoint":
        return MultiPoint([Point(c) for c in coords])
    if gtype == "MultiLineString":
        return MultiLineString([LineString(c) for c in coords])
    if gtype == "MultiPolygon":
        return MultiPolygon([Polygon(c[0], c[1:]) for c in coords])
    msg = f"Unsupported GeoJSON geometry type: {gtype}"
    raise ValueError(msg)


def wkt_to_geometry(wkt: str) -> Geometry:
    """Decode a WKT string (the types this module produces)."""
    wkt = wkt.strip()
    name, _, rest = wkt.partition("(")
    name = name.strip().upper()
    body = "(" + rest

    def parse_ring(text: str) -> list:
        return [
            [float(v) for v in pt.strip().split()]
            for pt in text.strip().strip("()").split(",")
        ]

    if name == "POINT":
        x, y = body.strip("() ").split()
        return Point(float(x), float(y))
    if name == "LINESTRING":
        return LineString(parse_ring(body))
    if name == "POLYGON":
        rings = _split_rings(body)
        return Polygon(parse_ring(rings[0]), [parse_ring(r) for r in rings[1:]])
    if name == "MULTIPOINT":
        groups = _depth2_groups(body)
        if groups:  # "((0 0), (2 2))" form
            return MultiPoint(
                [Point(*parse_ring(g)[0]) for g in groups]
            )
        # bare "(0 0, 2 2)" form
        return MultiPoint([Point(x, y) for x, y in parse_ring(body)])
    if name == "MULTILINESTRING":
        return MultiLineString(
            [LineString(parse_ring(g)) for g in _depth2_groups(body)]
        )
    if name == "MULTIPOLYGON":
        polys = []
        for group in _depth2_groups(body):
            rings = _split_rings(group)
            polys.append(
                Polygon(parse_ring(rings[0]), [parse_ring(r) for r in rings[1:]])
            )
        return MultiPolygon(polys)
    if name.replace(" ", "") == "GEOMETRYCOLLECTIONEMPTY":
        return GeometryCollection([])
    if name == "GEOMETRYCOLLECTION":
        return GeometryCollection(
            [wkt_to_geometry(m) for m in _split_top_level(body)]
        )
    msg = f"Unsupported WKT type: {name}"
    raise ValueError(msg)


def _split_top_level(body: str) -> list[str]:
    """Split a GEOMETRYCOLLECTION body into member WKT strings.

    Members are comma-separated at parenthesis depth 1 (each member
    carries its own type name and parenthesized coordinates).
    """
    body = body.strip()
    if not body.startswith("(") or not body.endswith(")"):
        msg = "Malformed GEOMETRYCOLLECTION body"
        raise ValueError(msg)
    inner = body[1:-1]
    members = []
    depth = 0
    start = 0
    for i, ch in enumerate(inner):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                msg = "Unbalanced parentheses in WKT body"
                raise ValueError(msg)
        elif ch == "," and depth == 0:
            members.append(inner[start:i].strip())
            start = i + 1
    if depth != 0:
        msg = "Unbalanced parentheses in WKT body"
        raise ValueError(msg)
    tail = inner[start:].strip()
    if tail:
        members.append(tail)
    return members


def _depth2_groups(body: str) -> list[str]:
    """Parenthesized groups at nesting depth 2 of a WKT body.

    Raises on unbalanced parentheses — a truncated ``MULTIPOLYGON (((``
    must fail loudly, not decode as an empty collection.
    """
    groups = []
    depth = 0
    start = None
    for i, ch in enumerate(body):
        if ch == "(":
            depth += 1
            if depth == 2:
                start = i
        elif ch == ")":
            if depth == 2:
                groups.append(body[start : i + 1])
            depth -= 1
            if depth < 0:
                msg = "Unbalanced parentheses in WKT body"
                raise ValueError(msg)
    if depth != 0:
        msg = "Unbalanced parentheses in WKT body"
        raise ValueError(msg)
    return groups


def _split_rings(body: str) -> list[str]:
    rings = _depth2_groups(body)
    if not rings:  # single ring at depth 1: POLYGON ((..)) already depth2; fallback
        rings = [body]
    return rings
