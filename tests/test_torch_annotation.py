"""The port's annotation package against JAX's (``annotation/``).

Seeded geometries give the same WKB, WKT and GeoJSON and the same
predicates in both packages; every DSL expression of ``test_dsl.py``
compiles to the same SQL and evaluates the same in Python; the stores of
both packages, filled with the same seeded annotations under the same keys,
answer ``query``, ``iquery``, ``bquery``, ``pquery`` and ``nquery`` alike;
and a ``.db`` written by either package opens in the other with equal
annotations.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from test_dsl import EXPRESSIONS, SAMPLES

from tiatoolbox_tpu.annotation import dsl as jdsl
from tiatoolbox_tpu.annotation import geometry as jg
from tiatoolbox_tpu.annotation import storage as js
from tiatoolbox_tpu.enums import GeometryType as JaxGeometryType
from tiatoolbox_tpu_torch.annotation import dsl as pdsl
from tiatoolbox_tpu_torch.annotation import geometry as pg
from tiatoolbox_tpu_torch.annotation import storage as ps
from tiatoolbox_tpu_torch.enums import GeometryType


def _geometries(g, seed: int) -> list:
    """Seeded geometries of every kind, built with geometry module ``g``."""
    rng = np.random.default_rng(seed)

    def ring(cx, cy, r, n):
        t = np.sort(rng.uniform(0, 2 * np.pi, n))
        return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=-1)

    out = []
    for _ in range(6):
        cx, cy = rng.uniform(0, 1000, 2)
        out.append(g.Point(cx, cy))
        out.append(g.LineString(rng.uniform(0, 1000, (int(rng.integers(2, 7)), 2))))
        out.append(g.Polygon(ring(cx, cy, 40, 9), [ring(cx, cy, 10, 5)]))
        out.append(g.Polygon.from_bounds(cx, cy, cx + rng.uniform(1, 50), cy + 7.25))
    out.append(g.MultiPoint([g.Point(*p) for p in rng.uniform(0, 50, (4, 2))]))
    out.append(g.MultiLineString([g.LineString(rng.uniform(0, 50, (3, 2))) for _ in range(2)]))
    out.append(g.MultiPolygon([g.Polygon(ring(x, 10, 5, 6)) for x in (0, 20, 40)]))
    out.append(g.GeometryCollection([g.Point(1, 2), g.LineString([[0, 0], [3, 4]]), g.Polygon(ring(9, 9, 3, 5))]))
    return out


def test_geometry_codecs_and_measures_match_jax() -> None:
    for want, got in zip(_geometries(jg, 3), _geometries(pg, 3)):
        assert got.to_wkb() == want.to_wkb()
        assert got.to_wkt() == want.to_wkt()
        assert json.dumps(got.to_geojson_dict()) == json.dumps(want.to_geojson_dict())
        assert got.bounds == want.bounds
        assert got.area == want.area and got.length == want.length
        assert got.centroid.to_wkb() == want.centroid.to_wkb()
        assert GeometryType(got.geom_type) == JaxGeometryType(want.geom_type)
        # each package decodes the other's bytes and text
        assert pg.wkb_to_geometry(want.to_wkb()).to_wkb() == want.to_wkb()
        assert jg.wkb_to_geometry(got.to_wkb()).to_wkb() == want.to_wkb()
        text = want.to_wkt()  # WKT rounds: held to JAX's decode of the same text
        assert pg.wkt_to_geometry(text).to_wkb() == jg.wkt_to_geometry(text).to_wkb()
        feature = want.to_geojson_dict()
        assert pg.geojson_to_geometry(feature).to_wkb() == jg.geojson_to_geometry(feature).to_wkb()


def test_geometry_predicates_match_jax() -> None:
    want_geoms, got_geoms = _geometries(jg, 5), _geometries(pg, 5)
    for a in range(len(want_geoms)):
        for b in range(0, len(want_geoms), 3):
            wa, wb, ga, gb = want_geoms[a], want_geoms[b], got_geoms[a], got_geoms[b]
            assert pg.geometry_intersects(ga, gb) == jg.geometry_intersects(wa, wb)
            assert pg.geometry_contains(ga, gb) == jg.geometry_contains(wa, wb)
            assert pg.geometry_distance(ga, gb) == jg.geometry_distance(wa, wb)
            assert ga.bbox_intersects(gb) == wa.bbox_intersects(wb)
        assert got_geoms[a].buffer(3.5).to_wkb() == want_geoms[a].buffer(3.5).to_wkb()


@pytest.mark.parametrize(("expr", "expected"), EXPRESSIONS)
def test_dsl_compiles_to_the_same_sql_and_python(expr: str, expected: set) -> None:
    del expected
    try:
        want = eval(expr, jdsl.SQL_GLOBALS, {"props": jdsl.SQLJSONDictionary()})  # noqa: S307
    except TypeError:  # not compilable: both stores filter in Python
        with pytest.raises(TypeError):
            eval(expr, pdsl.SQL_GLOBALS, {"props": pdsl.SQLJSONDictionary()})  # noqa: S307
    else:
        got = eval(expr, pdsl.SQL_GLOBALS, {"props": pdsl.SQLJSONDictionary()})  # noqa: S307
        assert str(got) == str(want)
    for props in SAMPLES:
        try:
            want_value = eval(expr, jdsl.PY_GLOBALS, {"props": props})  # noqa: S307
        except (KeyError, TypeError) as exc:
            with pytest.raises(type(exc)):
                eval(expr, pdsl.PY_GLOBALS, {"props": props})  # noqa: S307
            continue
        assert eval(expr, pdsl.PY_GLOBALS, {"props": props}) == want_value  # noqa: S307


def test_dsl_sql_functions_match_jax() -> None:
    for pattern, text, flags in (("a$", "beta", 0), ("GAM", "Gamma", 2), ("x", "abc", 0)):
        assert pdsl.py_regexp(pattern, text, flags) == jdsl.py_regexp(pattern, text, flags)
    assert pdsl.json_list_sum("[1, 2.5, 3]") == jdsl.json_list_sum("[1, 2.5, 3]")
    assert pdsl.json_contains("[1, 2]", 2) == jdsl.json_contains("[1, 2]", 2)
    assert pdsl.json_contains('{"a": 1}', "b") == jdsl.json_contains('{"a": 1}', "b")


def _annotations(g, s, seed: int) -> tuple[list, list[str]]:
    rng = np.random.default_rng(seed)
    anns, keys = [], []
    for i in range(60):
        cx, cy = rng.uniform(0, 500, 2)
        kind = i % 3
        if kind == 0:
            geom = g.Point(cx, cy).buffer(float(rng.uniform(2, 15)))
        elif kind == 1:
            geom = g.Point(cx, cy)
        else:
            geom = g.LineString([[cx, cy], [cx + 20, cy + rng.uniform(-9, 9)]])
        props = {
            "type": int(rng.integers(0, 4)),
            "prob": round(float(rng.random()), 6),
            "name": ["tumour", "stroma", "lymph"][i % 3],
        }
        anns.append(s.Annotation(geom, props))
        keys.append(f"k{i:03d}")
    return anns, keys


def _content(result: dict) -> dict:
    return {k: (a.geometry.to_wkb(), json.dumps(a.properties, sort_keys=True)) for k, a in result.items()}


QUERIES = [
    {"geometry": (100, 100, 300, 300)},
    {"geometry": (0, 0, 500, 500), "where": 'props["type"] == 2'},
    {"geometry": (50, 50, 250, 400), "where": '(props["prob"] > 0.5) & (props["name"] == "tumour")'},
    {"geometry": (100, 100, 300, 300), "geometry_predicate": "contains"},
    {"geometry": (100, 100, 300, 300), "geometry_predicate": "bbox_intersects"},
    {"geometry": (200, 200, 210, 210), "distance": 25},
    {"where": 'props["type"] >= 1'},
]


@pytest.mark.parametrize("backend", ["SQLiteStore", "DictionaryStore"])
def test_store_queries_match_jax(backend: str) -> None:
    jax_anns, keys = _annotations(jg, js, 21)
    port_anns, _ = _annotations(pg, ps, 21)
    want_store, got_store = getattr(js, backend)(), getattr(ps, backend)()
    want_store.append_many(jax_anns, keys=keys)
    got_store.append_many(port_anns, keys=keys)
    assert len(got_store) == len(want_store) == 60
    for q in QUERIES:
        assert _content(got_store.query(**q)) == _content(want_store.query(**q)), q
        iq = {k: v for k, v in q.items() if k != "min_area"}
        assert sorted(got_store.iquery(**iq)) == sorted(want_store.iquery(**iq)), q
    for geometry, where in (((0, 0, 250, 250), None), (None, 'props["type"] == 3'), ((0, 0, 500, 500), 'props["prob"] < 0.3')):
        assert got_store.bquery(geometry, where) == want_store.bquery(geometry, where)
    assert got_store.pquery('props["type"]') == want_store.pquery('props["type"]')
    assert got_store.pquery('props["name"]', (0, 0, 250, 250), unique=False) == want_store.pquery(
        'props["name"]', (0, 0, 250, 250), unique=False
    )
    assert got_store.pquery("*", where='props["type"] == 1', unique=False) == want_store.pquery(
        "*", where='props["type"] == 1', unique=False
    )
    for mode in ("poly-poly", "box-box", "boxpoint-boxpoint"):
        want = want_store.nquery(where='props["type"] == 0', n_where='props["type"] == 1', distance=60, mode=mode)
        got = got_store.nquery(where='props["type"] == 0', n_where='props["type"] == 1', distance=60, mode=mode)
        assert {k: _content(v) for k, v in got.items()} == {k: _content(v) for k, v in want.items()}, mode


def _rows(store) -> list:
    return sorted((a.geometry.to_wkb(), json.dumps(a.properties, sort_keys=True)) for a in store.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_files_open_in_the_other_package(tmp_path, writer: str) -> None:
    (wg, ws), (rs) = ((jg, js), ps) if writer == "jax" else ((pg, ps), js)
    anns, keys = _annotations(wg, ws, 33)
    path = tmp_path / "store.db"
    store = ws.SQLiteStore(path)
    store.append_many(anns, keys=keys)
    store.commit()
    want = _rows(store)
    store.close()
    opened = rs.AnnotationStore.open(path)
    assert isinstance(opened, rs.SQLiteStore)
    assert sorted(opened.keys()) == keys
    assert _rows(opened) == want
    assert sorted(opened.iquery((100, 100, 300, 300))) == sorted(
        ws.SQLiteStore(path).iquery((100, 100, 300, 300))
    )
    opened.close()


def test_sqlite_has_rtree_and_json() -> None:
    options = ps.SQLiteStore.compile_options()
    assert options == js.SQLiteStore.compile_options()
    store = ps.SQLiteStore()
    assert store.con.execute("SELECT json_extract('{\"a\": 2}', '$.a')").fetchone() == (2,)
    assert store.con.execute("SELECT count(*) FROM rtree").fetchone() == (0,)


@pytest.mark.parametrize("backend", ["SQLiteStore", "DictionaryStore"])
def test_appends_after_removals_match_jax(backend: str) -> None:
    """Rows and their R*Tree boxes stay paired across appends, removals and
    replacements (the port inserts a batch with the ids SQLite would give)."""
    jax_anns, keys = _annotations(jg, js, 44)
    port_anns, _ = _annotations(pg, ps, 44)
    want_store, got_store = getattr(js, backend)(), getattr(ps, backend)()
    for store, anns in ((want_store, jax_anns), (got_store, port_anns)):
        store.append_many(anns[:30], keys=keys[:30])
        store.remove_many(keys[5:25:2])
        store[keys[29]] = anns[0]
        store.append_many(anns[30:], keys=keys[30:])
    for q in QUERIES:
        assert _content(got_store.query(**q)) == _content(want_store.query(**q)), q
    assert got_store.bquery() == want_store.bquery()
