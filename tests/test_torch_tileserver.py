"""The port's tile server against JAX's, route for route, through WSGI environs.

Both servers get the same slide, the same annotation store (each its own
copy of the ``.db`` file, as routes write to it), the same overlays and the
same sequence of requests. For every request the test compares the status,
the content type and the JSON body; the HTML pages byte for byte; JPEG
tiles byte for byte (the port's encoder writes cv2's bytes at quality 85)
and RGBA PNG tiles after decoding (the port's PNG writer is not cv2's).

``segment_on_box`` runs the registry's ``hovernet_fast-pannuke`` in both
packages with the functional HoVer-Net checkpoint under each package's
``TIATOOLBOX_HOME/models`` (JAX's flax ``.npz``, the port's ``.pth``), on
the box of ``tests/test_viewer_modelrun.py``: the instance counts and
types are equal and each polygon lies within 0.5 px of JAX's.
``prompt_segment`` runs an injected stub in both, as JAX's tests do.
"""

from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path
from urllib.parse import urlencode

import cv2
import joblib
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

from tiatoolbox_tpu import rcParam as jax_rc
from tiatoolbox_tpu.visualization.tileserver import TileServer as JaxTileServer
from tiatoolbox_tpu_torch import rcParam as port_rc
from tiatoolbox_tpu_torch.annotation.geometry import Point, Polygon
from tiatoolbox_tpu_torch.annotation.storage import Annotation, SQLiteStore
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch_exact
from tiatoolbox_tpu_torch.utils.misc import imwrite
from tiatoolbox_tpu_torch.visualization.tileserver import TileServer

BOX = {"x0": 100, "y0": 80, "x1": 500, "y1": 420}  # tests/test_viewer_modelrun.py:74-96
POLYGON_TOL = 0.5


def call(app, method: str, path: str, params: dict | None = None, query: str = "") -> tuple[str, str, bytes]:
    body = urlencode(params or {}).encode()
    environ = {
        "PATH_INFO": path,
        "REQUEST_METHOD": method,
        "QUERY_STRING": query,
        "CONTENT_LENGTH": str(len(body)),
        "wsgi.input": io.BytesIO(body),
    }
    seen = {}

    def start_response(status, headers):
        seen["status"], seen["headers"] = status, dict(headers)

    data = b"".join(app(environ, start_response))
    assert seen["headers"]["Content-Length"] == str(len(data))
    return seen["status"], seen["headers"]["Content-Type"], data


def make_store(path: Path) -> None:
    rng = np.random.default_rng(4)
    store = SQLiteStore()
    anns = []
    for i in range(30):
        cx, cy = rng.uniform(40, 700), rng.uniform(40, 500)
        r = rng.uniform(6, 20)
        t = np.linspace(0, 2 * np.pi, 9)[:-1]
        shell = np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=1)
        anns.append(Annotation(Polygon(shell), {"type": int(i % 3), "prob": float(rng.uniform()), "name": f"n{i % 4}"}))
    for i in range(5):
        anns.append(Annotation(Point(*rng.uniform(40, 700, 2)), {"type": 1, "prob": 0.5, "flag": bool(i % 2)}))
    store.append_many(anns)
    store.dump(str(path))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ts")
    slide = tmp / "slide.tiff"
    make_synthetic_slide(slide, size=(760, 560), mpp=0.25, objective_power=40, compression="deflate")
    slide2 = tmp / "slide2.tiff"
    make_synthetic_slide(slide2, size=(640, 480), mpp=0.25, objective_power=40, seed=5, compression="deflate")
    store = tmp / "anns.db"
    make_store(store)
    image = tmp / "overlay.png"
    imwrite(image, synthetic_he_patch_exact((190, 140), seed=2))
    affine = tmp / "affine.npy"
    angle = np.deg2rad(7.0)
    np.save(affine, np.array([[np.cos(angle), -np.sin(angle), 20.0], [np.sin(angle), np.cos(angle), -12.0], [0, 0, 1]]))
    dat = tmp / "nuclei.dat"
    joblib.dump(
        {
            f"i{k}": {
                "box": [10 * k, 10 * k, 10 * k + 8, 10 * k + 8],
                "centroid": [10 * k + 4.0, 10 * k + 4.0],
                "contour": [[10 * k, 10 * k], [10 * k + 8, 10 * k], [10 * k + 8, 10 * k + 8], [10 * k, 10 * k + 8]],
                "prob": 0.9,
                "type": k % 2,
            }
            for k in range(6)
        },
        dat,
    )
    rng = np.random.default_rng(0)
    graph = tmp / "graph.json"
    graph.write_text(
        json.dumps(
            {
                "coordinates": rng.uniform(20, 640, (12, 2)).tolist(),
                "edge_index": np.stack([np.arange(11), np.arange(1, 12)]).tolist(),
                "x": rng.random((12, 10)).tolist(),
            }
        )
    )
    graph_npz = tmp / "graph.npz"
    np.savez(graph_npz, coordinates=np.array([[10.0, 10.0], [200.0, 200.0], [400.0, 120.0]]),
             edge_index=np.array([[0, 1], [1, 2]]).T)
    stores = {}
    for name in ("jax", "port"):
        stores[name] = tmp / f"{name}_anns.db"
        shutil.copy(store, stores[name])
    return {"tmp": tmp, "slide": str(slide), "slide2": str(slide2), "stores": stores, "image": str(image),
            "affine": str(affine), "dat": str(dat), "graph": str(graph), "graph_npz": str(graph_npz)}


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    """The port's model runs go to ``rcParam["device"]``: the CPU here."""
    old = port_rc["device"]
    port_rc["device"] = "cpu"
    yield
    port_rc["device"] = old


def compare(got: tuple, want: tuple, what: str) -> None:
    assert got[0] == want[0], (what, got[0], want[0], got[2][:200], want[2][:200])
    assert got[1] == want[1], what
    if want[1] == "application/json":
        assert json.loads(got[2]) == json.loads(want[2]), what
    elif want[1] == "image/png":
        a = cv2.imdecode(np.frombuffer(got[2], np.uint8), cv2.IMREAD_UNCHANGED)
        b = cv2.imdecode(np.frombuffer(want[2], np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert got[2] == want[2], what


@pytest.fixture(scope="module")
def servers(files):
    jax = JaxTileServer(title="viewer", layers={"slide": files["slide"]})
    port = TileServer(title="viewer", layers={"slide": files["slide"]})
    return {"jax": jax, "port": port}


def both(servers, method, path, params=None, query="", per_server=None):
    """The request on both servers; ``per_server`` adds each server's own parameters."""
    out = {}
    for name, app in servers.items():
        p = dict(params or {})
        if per_server:
            p.update(per_server(name))
        out[name] = call(app, method, path, p, query)
    compare(out["port"], out["jax"], f"{method} {path} {params}")
    return out["port"]


READS = [
    ("GET", "/", None),
    ("GET", "/viewer", None),
    ("GET", "/tileserver/layers", None),
    ("GET", "/tileserver/info/slide", None),
    ("GET", "/tileserver/info/nope", None),
    ("GET", "/tileserver/healthcheck", None),
    ("GET", "/tileserver/sessions", None),
    ("GET", "/tileserver/slide", None),
    ("GET", "/nope", None),
    ("GET", "/tileserver/nope", None),
    ("GET", "/tileserver/channels", None),
    ("GET", "/tileserver/enhance", None),
    ("GET", "/tileserver/prop_names", None),
    ("GET", "/tileserver/annotations", None),
    ("GET", "/tileserver/graph", None),
    ("GET", "/tileserver/secondary_cmap", None),
    ("GET", "/tileserver/color_prop", None),
    ("GET", "/tileserver/cmap", None),
    ("GET", "/tileserver/commit", None),
]


@pytest.mark.parametrize(("method", "path", "params"), READS, ids=[r[1] for r in READS])
def test_fresh_server_routes(files, method, path, params) -> None:
    fresh = {
        "jax": JaxTileServer(title="viewer", layers={"slide": files["slide"]}),
        "port": TileServer(title="viewer", layers={"slide": files["slide"]}),
    }
    both(fresh, method, path, params)


def slide_tiles() -> list[tuple[int, int, int]]:
    # 760x560 in 256^2 tiles: levels 0-4 (the zoomify level count)
    return [(0, 0, 0), (1, 0, 0), (2, 1, 0), (3, 1, 1), (3, 2, 2), (4, 2, 1), (4, 0, 2), (4, 5, 5)]


def test_session_sequence(servers, files) -> None:
    """One session's worth of control requests, in order, on both servers."""
    s = servers
    for z, x, y in slide_tiles():
        both(s, "GET", f"/tileserver/layer/slide/default/zoomify/TileGroup0/{z}-{x}-{y}.jpg")
    both(s, "PUT", "/tileserver/annotations", {"model_mpp": "0.5"},
         per_server=lambda name: {"file_path": str(files["stores"][name])})
    for method, path, params, query in [
        ("GET", "/tileserver/annotations", None, ""),
        ("GET", "/tileserver/layers", None, ""),
        ("GET", "/tileserver/info/overlay", None, ""),
        ("GET", "/tileserver/prop_names", None, ""),
        ("GET", "/tileserver/prop_names/1", None, ""),
        ("GET", "/tileserver/prop_values/type", None, ""),
        ("GET", "/tileserver/prop_values/name/0", None, ""),
        ("GET", "/tileserver/prop_range", None, "prop=prob"),
        ("PUT", "/tileserver/prop_range", {"prop": "prob"}, ""),
        ("GET", "/tileserver/prop_stats/prob", None, "bins=7"),
        ("GET", "/tileserver/prop_stats/name", None, ""),
        ("GET", "/tileserver/prop_stats/flag", None, ""),
        ("GET", "/tileserver/prop_stats/missing", None, ""),
        ("PUT", "/tileserver/color_prop", {"prop": "prob"}, ""),
        ("GET", "/tileserver/color_prop", None, ""),
        ("PUT", "/tileserver/cmap", {"cmap": "viridis"}, ""),
        ("GET", "/tileserver/cmap", None, ""),
        ("PUT", "/tileserver/renderer/thickness", {"val": "2"}, ""),
        ("GET", "/tileserver/renderer/thickness", None, ""),
        ("PUT", "/tileserver/renderer/edge_thickness", {"val": "0"}, ""),
        ("PUT", "/tileserver/secondary_cmap", {"type_id": "1", "prop": "prob", "cmap": "jet"}, ""),
        ("GET", "/tileserver/secondary_cmap", None, ""),
        ("GET", "/tileserver/commit", None, ""),
        ("GET", "/tileserver/channels", None, ""),
    ]:
        both(s, method, path, params, query)
    for x, y in ((120.0, 90.0), (5.0, 5.0)):
        both(s, "GET", f"/tileserver/tap_query/overlay/{x}/{y}")
    ann = next(iter(s["port"].layers["overlay"].values()))
    cx, cy = np.asarray(ann.geometry.shell).mean(axis=0)
    got = both(s, "GET", f"/tileserver/tap_query/overlay/{cx}/{cy}")
    assert json.loads(got[2])["annotations"]
    for z, x, y in ((1, 0, 0), (3, 1, 1), (4, 1, 1), (4, 2, 0)):
        both(s, "GET", f"/tileserver/layer/overlay/default/zoomify/TileGroup0/{z}-{x}-{y}.jpg")
    both(s, "PUT", "/tileserver/cmap", {"cmap": json.dumps({"0": [1, 0, 0], "1": [0, 1, 0], "2": [0, 0, 1]})})
    both(s, "PUT", "/tileserver/color_prop", {"prop": "type"})
    both(s, "GET", "/tileserver/layer/overlay/default/zoomify/TileGroup0/4-1-1.jpg")
    # an image overlay, a .dat overlay, a graph, then clear
    got = both(s, "PUT", "/tileserver/overlay", {"overlay_path": files["image"]})
    assert json.loads(got[2]) == {"layer": "layer0"}
    both(s, "GET", "/tileserver/layer/layer0/default/zoomify/TileGroup0/0-0-0.jpg")
    got = both(s, "PUT", "/tileserver/overlay", {"overlay_path": files["dat"]})
    assert json.loads(got[2]) == {"types": ["0", "1"]}
    both(s, "GET", "/tileserver/layer/overlay/default/zoomify/TileGroup0/4-0-0.jpg")
    got = both(s, "PUT", "/tileserver/graph", {"graph_path": files["graph"]})
    assert json.loads(got[2])["edges"] == 11
    both(s, "PUT", "/tileserver/color_prop", {"prop": "feat_0"})
    both(s, "PUT", "/tileserver/prop_range", {"prop": "feat_0"})
    both(s, "GET", "/tileserver/layer/graph_nodes/default/zoomify/TileGroup0/2-0-0.jpg")
    both(s, "GET", "/tileserver/layer/graph_edges/default/zoomify/TileGroup0/2-0-0.jpg")
    both(s, "PUT", "/tileserver/graph", {"graph_path": files["graph_npz"]})
    both(s, "GET", "/tileserver/graph")
    both(s, "PUT", "/tileserver/clear_overlays")
    both(s, "GET", "/tileserver/layers")
    both(s, "PUT", "/tileserver/segment_on_box", {"x0": "0", "y0": "0", "x1": "100"})  # 400, missing y1
    both(s, "PUT", "/tileserver/prompt_segment")  # 400, no prompt
    both(s, "PUT", "/tileserver/shutdown")


def test_sessions_and_registration_overlay(servers, files) -> None:
    s = servers
    both(s, "PUT", "/tileserver/slide", {"session_id": "split", "slide_path": files["slide2"]})
    both(s, "GET", "/tileserver/sessions")
    both(s, "GET", "/tileserver/slide", query="session_id=split")
    both(s, "GET", "/tileserver/layer/slide/split/zoomify/TileGroup0/4-1-1.jpg")
    got = both(s, "PUT", "/tileserver/overlay", {"session_id": "split", "overlay_path": files["affine"]})
    assert json.loads(got[2]) == {"layer": "slide"}
    for z, x, y in ((2, 0, 0), (4, 1, 1), (4, 2, 1)):
        both(s, "GET", f"/tileserver/layer/slide/split/zoomify/TileGroup0/{z}-{x}-{y}.jpg")
    both(s, "PUT", "/tileserver/reset/split")
    both(s, "GET", "/tileserver/sessions")
    ids = {name: json.loads(call(app, "PUT", "/tileserver/session_id")[2]) for name, app in s.items()}
    assert all(len(v["session_id"]) == 32 for v in ids.values())


# -- the interactive model runs --------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint_homes(tmp_path_factory):
    """The functional HoVer-Net checkpoint under each package's own TIATOOLBOX_HOME."""
    from tiatoolbox_tpu.models.architecture.weight_converter import save_flax_npz
    from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import (
        functional_hovernet_state_dict,
        functional_hovernet_variables,
    )

    homes = {name: tmp_path_factory.mktemp(f"home_{name}") for name in ("jax", "port")}
    for home in homes.values():
        (home / "models").mkdir()
    save_flax_npz(functional_hovernet_variables(), homes["jax"] / "models" / "hovernet_fast-pannuke.npz")
    torch.save(functional_hovernet_state_dict(), homes["port"] / "models" / "hovernet_fast-pannuke.pth")
    old = jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"]
    jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"] = str(homes["jax"]), homes["port"]
    yield homes
    jax_rc["TIATOOLBOX_HOME"], port_rc["TIATOOLBOX_HOME"] = old


def matched_polygons(got: list, want: list) -> float:
    """Pair each polygon with JAX's of the nearest centroid; the largest vertex distance."""
    worst = 0.0
    want_c = np.array([w.mean(axis=0) for w in want])
    for poly in got:
        j = int(np.argmin(np.abs(want_c - poly.mean(axis=0)).sum(axis=1)))
        other = want[j]
        assert len(poly) == len(other)
        worst = max(worst, float(np.abs(poly - other).max()))
    return worst


def test_segment_on_box_against_jax(files, checkpoint_homes) -> None:
    torch.set_num_threads(4)
    servers = {
        "jax": JaxTileServer(layers={"slide": files["slide"]}),
        "port": TileServer(layers={"slide": files["slide"]}),
    }
    got = both(servers, "PUT", "/tileserver/segment_on_box", {k: str(v) for k, v in BOX.items()})
    result = json.loads(got[2])
    assert result["layer"] == "segment" and result["count"] > 5
    stores = {name: app.layers["segment"] for name, app in servers.items()}
    rows = {
        name: sorted(
            ((a.properties["type"], np.asarray(a.geometry.shell, float)) for a in store.values()),
            key=lambda r: (r[0], *np.round(r[1].mean(axis=0), 1)),
        )
        for name, store in stores.items()
    }
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    assert matched_polygons([r[1] for r in rows["port"]], [r[1] for r in rows["jax"]]) <= POLYGON_TOL
    for z, x, y in ((2, 0, 0), (4, 1, 1)):
        both(servers, "GET", f"/tileserver/layer/segment/default/zoomify/TileGroup0/{z}-{x}-{y}.jpg")


class _Stub:
    """A prompt segmentor stub: a 50x50 square mask in the read window, written
    by the package's own ``dict_to_store_semantic_segmentor``."""

    scale = 1.0
    offset = np.array([0, 0])

    def __init__(self, convert) -> None:
        self.convert = convert
        self.calls = []

    def run(self, images, point_coords=None, box_coords=None, save_dir=None, device=None):
        self.calls.append((np.asarray(images[0]).shape, point_coords, box_coords, device))
        mask = np.zeros(np.asarray(images[0]).shape[:2], np.uint8)
        mask[10:60, 10:60] = 1
        out = Path(save_dir) / "0.db"
        self.convert({"predictions": mask}, scale_factor=(self.scale, self.scale), offset=tuple(self.offset),
                     save_path=out)
        return [out]


@pytest.mark.parametrize(
    "prompt",
    [{"points": json.dumps([[300.0, 300.0]])}, {"box": json.dumps([120.0, 100.0, 360.0, 300.0])}],
    ids=["points", "box"],
)
def test_prompt_segment_with_stub(files, prompt) -> None:
    from tiatoolbox_tpu.utils.store_conversion import dict_to_store_semantic_segmentor as jax_convert
    from tiatoolbox_tpu_torch.utils.store_conversion import dict_to_store_semantic_segmentor as port_convert

    stubs = {"jax": _Stub(jax_convert), "port": _Stub(port_convert)}
    servers = {
        "jax": JaxTileServer(layers={"slide": files["slide"]}, prompt_segmentor=stubs["jax"]),
        "port": TileServer(layers={"slide": files["slide"]}, prompt_segmentor=stubs["port"]),
    }
    got = both(servers, "PUT", "/tileserver/prompt_segment", prompt)
    assert json.loads(got[2]) == {"count": 1, "layer": "prompt"}
    shape, points, box, device = stubs["port"].calls[0]
    assert (shape, device) == (stubs["jax"].calls[0][0], None)  # the engine resolves rcParam["device"]
    np.testing.assert_array_equal(points if points is not None else box,
                                  stubs["jax"].calls[0][1] if points is not None else stubs["jax"].calls[0][2])
    bounds = {name: sorted(a.geometry.bounds for a in app.layers["prompt"].values()) for name, app in servers.items()}
    np.testing.assert_allclose(bounds["port"], bounds["jax"])
    both(servers, "GET", "/tileserver/layer/prompt/default/zoomify/TileGroup0/4-1-1.jpg")
