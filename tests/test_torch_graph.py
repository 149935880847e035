"""The slide graph, UMAP and the Kather dataset info: the port against the JAX package.

Tolerances:

- ``SlideGraphConstructor.build``, ``delaunay_adjacency``,
  ``edge_index_to_triangles``, ``affinity_to_edge_index`` and
  ``triangle_signed_area``: equal (the same clusters, centroids and edges);
  ``_pca_reducer`` within 1e-12.
- UMAP: the kNN table equals scikit-learn's (indices equal, distances within
  1e-6: cKDTree and scikit-learn sum the squares in another order), the fuzzy
  graph built from one table equals JAX's bit for bit (from each package's
  own search within 1e-5), and from one graph
  and one spectral start every epoch is JAX's bit for bit. JAX's eigensolver
  start is ARPACK's own random vector, which runs on between calls, so JAX's
  seeded embedding differs from itself between two calls in one process;
  end to end the port is held to the structure JAX's own tests check
  (cluster separation, kNN overlap) and to repeating itself exactly.
- ``KatherPatchDataset``: the synthetic stand-in's labels equal, its 128
  patches within 1 level in at most 16 values (10 measured) of 19.3
  million: JAX's noise fields come from IPP's float32 cubic resize; a
  local ``<dir>/<CLASS>/*.tif`` tree reads the same items.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from tiatoolbox_tpu.models.dataset import info as jax_info
from tiatoolbox_tpu.tools import graph as jax_graph
from tiatoolbox_tpu.tools import umap_lite as jax_umap
from tiatoolbox_tpu_torch.models.dataset import info as port_info
from tiatoolbox_tpu_torch.tools import graph as port_graph
from tiatoolbox_tpu_torch.tools import umap_lite as port_umap

PCA_TOL = 1e-12
KNN_DIST_TOL = 1e-6
FUZZY_GRAPH_TOL = 1e-5
STAND_IN_MAX_LEVELS = 1
STAND_IN_MAX_VALUES = 16


def _graph_inputs(case: str):
    """The seeded cases of tests/test_registration_graph.py and tests/test_umap_lite.py, and two more."""
    if case == "registration":
        rng = np.random.default_rng(0)
        points = rng.random((60, 2)) * 1000
        features = np.array([rng.random(16) * n for n in range(60)])
        return points, features, {"lambda_h": 0.3}
    if case == "umap_lite":
        rng = np.random.default_rng(0)
        points = rng.uniform(0, 4000, (300, 2))
        features = np.concatenate([k + rng.random((100, 16)) for k in range(3)])
        return points, features, {}
    if case == "slide":
        rng = np.random.default_rng(7)
        points = np.round(rng.uniform(0, 20000, (266, 2)))
        features = rng.normal(0, 1, (266, 64)).astype(np.float32)
        return points, features, {"connectivity_distance": 4000}
    rng = np.random.default_rng(3)
    points = rng.integers(0, 5000, (120, 2)).astype(float)
    features = rng.random((120, 8))
    features[:, 3] = 0.5  # a flat feature, dropped by feature_range_thresh
    return points, features, {"lambda_d": 1e-3, "lambda_f": 5e-3}


@pytest.mark.parametrize("case", ["registration", "umap_lite", "slide", "flat_feature"])
def test_build_as_jax(case: str) -> None:
    points, features, kwargs = _graph_inputs(case)
    want = jax_graph.SlideGraphConstructor.build(points, features, **kwargs)
    got = port_graph.SlideGraphConstructor.build(points, features, **kwargs)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(
        port_graph.SlideGraphConstructor._pca_reducer(got),
        jax_graph.SlideGraphConstructor._pca_reducer(want),
        rtol=0, atol=PCA_TOL,
    )


def test_graph_helpers_as_jax() -> None:
    rng = np.random.default_rng(1)
    points = rng.random((30, 2)) * 100
    for dthresh in (10, 25.5, 1000):
        np.testing.assert_array_equal(
            port_graph.delaunay_adjacency(points, dthresh), jax_graph.delaunay_adjacency(points, dthresh)
        )
    adjacency = port_graph.delaunay_adjacency(points, 30)
    edge_index = port_graph.affinity_to_edge_index(adjacency)
    np.testing.assert_array_equal(edge_index, jax_graph.affinity_to_edge_index(adjacency))
    np.testing.assert_array_equal(
        port_graph.edge_index_to_triangles(edge_index), jax_graph.edge_index_to_triangles(edge_index)
    )
    for tri in rng.random((10, 3, 2)):
        assert port_graph.triangle_signed_area(tri) == jax_graph.triangle_signed_area(tri)
    for fn, args, error in (
        ("delaunay_adjacency", (points, "x"), TypeError),
        ("delaunay_adjacency", (points[:3], 1.0), ValueError),
        ("triangle_signed_area", (np.zeros((2, 2)),), ValueError),
        ("affinity_to_edge_index", (np.zeros((2, 3)),), ValueError),
    ):
        with pytest.raises(error):
            getattr(port_graph, fn)(*args)
        with pytest.raises(error):
            getattr(jax_graph, fn)(*args)


def test_visualise_refused_by_name() -> None:
    points, features, kwargs = _graph_inputs("registration")
    graph = port_graph.SlideGraphConstructor.build(points, features, **kwargs)
    with pytest.raises(NotImplementedError, match="item 8"):
        port_graph.SlideGraphConstructor.visualise(graph)


def _three_clusters(n_per: int = 40, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0] * 10, [8.0] * 10, [-8.0, 8.0] * 5])
    x = np.concatenate([c + rng.normal(0, 0.5, (n_per, 10)) for c in centers]).astype(np.float32)
    return x, np.repeat(np.arange(3), n_per)


UMAP_INPUTS = {
    "three_clusters": lambda: _three_clusters()[0],
    "three_clusters_30": lambda: _three_clusters(30, 1)[0],
    "tiny": lambda: np.random.default_rng(0).random((8, 4)).astype(np.float32),
    "slide_graph": lambda: port_graph.SlideGraphConstructor.build(*_graph_inputs("umap_lite")[:2])["x"].astype(np.float32),
}


@pytest.mark.parametrize("case", sorted(UMAP_INPUTS))
def test_knn_and_fuzzy_graph_as_jax(case: str) -> None:
    from sklearn.neighbors import NearestNeighbors

    x = UMAP_INPUTS[case]()
    k = min(15, len(x) - 1)
    want_d, want_i = NearestNeighbors(n_neighbors=k + 1).fit(x).kneighbors(x)
    got_d, got_i = port_umap.nearest_neighbors(x, 15)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=KNN_DIST_TOL)
    # from one kNN table the fuzzy graph is JAX's to the bit
    want = jax_umap._fuzzy_simplicial_set(x, 15)
    got = port_umap.fuzzy_simplicial_set_from_knn(want_d, want_i)
    assert (got != want).nnz == 0
    np.testing.assert_allclose(
        port_umap._fuzzy_simplicial_set(x, 15).toarray(), want.toarray(), rtol=0, atol=FUZZY_GRAPH_TOL
    )


@pytest.mark.parametrize("case", sorted(UMAP_INPUTS))
@pytest.mark.parametrize("n_epochs", [1, 3, 40])
def test_epochs_as_jax(case: str, n_epochs: int, monkeypatch) -> None:
    """From one fuzzy graph and one spectral start, every epoch is JAX's to the bit."""
    x = UMAP_INPUTS[case]()
    graph = jax_umap._fuzzy_simplicial_set(x, 15)
    start_rng = np.random.default_rng(0)
    start = port_umap._spectral_init(graph.tocsr(), 2, start_rng)
    for module in (jax_umap, port_umap):
        monkeypatch.setattr(module, "_fuzzy_simplicial_set", lambda *_a, g=graph: g.copy())
        monkeypatch.setattr(module, "_spectral_init", lambda _g, _c, rng, s=start: s + rng.normal(0, 1e-4, s.shape) * 0)
    want = jax_umap.UMAP(n_components=2, n_epochs=n_epochs, random_state=0).fit_transform(x)
    got = port_umap.UMAP(n_components=2, n_epochs=n_epochs, random_state=0).fit_transform(x)
    np.testing.assert_array_equal(got, want)


def test_umap_repeats_itself_and_keeps_structure() -> None:
    from sklearn.neighbors import NearestNeighbors

    x, labels = _three_clusters()
    first = port_umap.UMAP(n_components=2, n_epochs=120, random_state=0).fit_transform(x)
    again = port_umap.UMAP(n_components=2, n_epochs=120, random_state=0).fit_transform(x)
    np.testing.assert_array_equal(first, again)
    centroids = np.stack([first[labels == k].mean(0) for k in range(3)])
    intra = max(np.linalg.norm(first[labels == k] - centroids[k], axis=1).mean() for k in range(3))
    inter = min(np.linalg.norm(centroids[i] - centroids[j]) for i in range(3) for j in range(i + 1, 3))
    assert inter > 2 * intra, (inter, intra)
    x, _ = _three_clusters(n_per=30, seed=1)
    emb = port_umap.UMAP(n_components=2, n_epochs=100, random_state=0).fit_transform(x)
    nn_in = NearestNeighbors(n_neighbors=11).fit(x).kneighbors(x)[1][:, 1:]
    nn_out = NearestNeighbors(n_neighbors=11).fit(emb).kneighbors(emb)[1][:, 1:]
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(nn_in, nn_out)]) >= 0.35


def test_ab_params_and_tiny_inputs_as_jax() -> None:
    assert port_umap._find_ab_params(1.0, 0.1) == jax_umap._find_ab_params(1.0, 0.1)
    np.testing.assert_array_equal(
        port_umap.UMAP(n_components=3).fit_transform(np.zeros((2, 5))),
        jax_umap.UMAP(n_components=3).fit_transform(np.zeros((2, 5))),
    )
    out = port_umap.UMAP(n_components=2, n_epochs=20).fit_transform(np.random.default_rng(0).random((8, 4)))
    assert np.isfinite(out).all()


def test_umap_reducer_colours() -> None:
    points, features, _ = _graph_inputs("umap_lite")
    graph = port_graph.SlideGraphConstructor.build(points, features)
    colours = port_graph.SlideGraphConstructor._umap_reducer(graph)
    assert colours.shape == (len(graph["x"]), 3)
    assert colours.min() >= 0 and colours.max() <= 1
    np.testing.assert_array_equal(colours, port_graph.SlideGraphConstructor._umap_reducer(graph))


def test_kather_stand_in_as_jax(tmp_path) -> None:
    missing = tmp_path / "no_such_dir"
    want = jax_info.KatherPatchDataset(missing)
    got = port_info.KatherPatchDataset(missing)
    assert got.label_names == want.label_names == port_info.KATHER_CLASSES
    assert got.labels == want.labels
    assert len(got) == len(want) == 128
    # JAX upsamples its noise fields with IPP's float32 cubic kernel (through
    # cv2); the port sums in float64: 10 of the 19.3 million values differ
    diff = np.abs(got.inputs.astype(int) - want.inputs)
    assert diff.max() <= STAND_IN_MAX_LEVELS and int(np.count_nonzero(diff)) <= STAND_IN_MAX_VALUES
    for idx in (0, 7, 127):
        assert got[idx]["label"] == want[idx]["label"]
        assert np.abs(got[idx]["image"].astype(int) - want[idx]["image"]).max() <= STAND_IN_MAX_LEVELS


def test_kather_local_tree_as_jax(tmp_path) -> None:
    rng = np.random.default_rng(2)
    for name in ("BACK", "TUM", "LYM"):
        (tmp_path / name).mkdir()
        for i in range(2):
            patch = rng.integers(0, 256, (32, 40, 3)).astype(np.uint8)
            cv2.imwrite(str(tmp_path / name / f"{name}-{i}.tif"), cv2.cvtColor(patch, cv2.COLOR_RGB2BGR))
    want = jax_info.KatherPatchDataset(tmp_path)
    got = port_info.KatherPatchDataset(tmp_path)
    assert [p.name for p in got.inputs] == [p.name for p in want.inputs]
    assert got.labels == want.labels
    for idx in range(len(want)):
        np.testing.assert_array_equal(got[idx]["image"], want[idx]["image"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No Kather100k"):
        port_info.KatherPatchDataset(tmp_path / "empty")
    assert issubclass(port_info.DatasetInfoABC, object)
    with pytest.raises(TypeError):
        port_info.DatasetInfoABC()
