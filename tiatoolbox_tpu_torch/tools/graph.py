"""SlideGraph construction (counterpart of ``tiatoolbox_tpu/tools/graph.py``).

Hybrid spatial and feature agglomerative clustering of patch features,
then a distance-thresholded Delaunay triangulation of the cluster centroids
into a graph ``{"x", "edge_index", "coordinates"}`` (JAX :21-175), on numpy
and scipy exactly as JAX's: the same clusters, edges and centroids on the
same input. Node colours come from the port's UMAP (``tools/umap_lite.py``)
or a PCA. ``visualise`` draws with matplotlib, which the port does not
have: it raises ``NotImplementedError`` (``ROADMAP.md`` section 1 item 8).
"""

from __future__ import annotations

from collections import defaultdict
from numbers import Number

import numpy as np
from scipy.cluster import hierarchy
from scipy.spatial import Delaunay, cKDTree


def delaunay_adjacency(points: np.ndarray, dthresh: float) -> np.ndarray:
    """Adjacency matrix via Delaunay triangulation with distance cutoff."""
    if not isinstance(dthresh, Number):
        msg = "dthresh must be a number."
        raise TypeError(msg)
    if len(points) < 4:
        msg = "Points must have length >= 4."
        raise ValueError(msg)
    if len(np.shape(points)) != 2:
        msg = "Points must have an NxM shape."
        raise ValueError(msg)
    tessellation = Delaunay(points)
    triangle_neighbours = defaultdict(set)
    for triplet in tessellation.simplices:
        for index in triplet:
            connected = set(triplet)
            connected.remove(index)
            triangle_neighbours[index] |= connected
    adjacency = np.zeros((len(points), len(points)))
    for index, neighbours in triangle_neighbours.items():
        neighbours = np.array(list(neighbours), dtype=int)
        kdtree = cKDTree(points[neighbours, :])
        nearby = kdtree.query_ball_point(x=points[index], r=dthresh)
        neighbours = neighbours[nearby]
        adjacency[index, neighbours] = 1.0
        adjacency[neighbours, index] = 1.0
    return adjacency


def triangle_signed_area(triangle) -> float:
    """Signed area of a 3x2 triangle (sign gives winding)."""
    triangle = np.asarray(triangle)
    if triangle.shape != (3, 2):
        msg = "Input triangle must be a 3x2 array."
        raise ValueError(msg)
    return 0.5 * (
        triangle[0, 0] * (triangle[1, 1] - triangle[2, 1])
        + triangle[1, 0] * (triangle[2, 1] - triangle[0, 1])
        + triangle[2, 0] * (triangle[0, 1] - triangle[1, 1])
    )


def edge_index_to_triangles(edge_index: np.ndarray) -> np.ndarray:
    """Find triangles (3-cliques) from a [2, M] edge index matrix."""
    edges = {tuple(sorted(e)) for e in edge_index.T.tolist()}
    neighbours = defaultdict(set)
    for a, b in edges:
        neighbours[a].add(b)
        neighbours[b].add(a)
    triangles = set()
    for a, b in edges:
        common = neighbours[a] & neighbours[b]
        for c in common:
            triangles.add(tuple(sorted((a, b, c))))
    return np.array(sorted(triangles), dtype=int)


def affinity_to_edge_index(
    affinity_matrix: np.ndarray,
    threshold: float = 0.5,
) -> np.ndarray:
    """Affinity matrix → [2, M] COO edge index of entries > threshold."""
    affinity_matrix = np.asarray(affinity_matrix)
    if affinity_matrix.ndim != 2 or (
        affinity_matrix.shape[0] != affinity_matrix.shape[1]
    ):
        msg = "Input affinity_matrix must be square (NxN)."
        raise ValueError(msg)
    return np.ascontiguousarray(np.stack(np.where(affinity_matrix > threshold)))


class SlideGraphConstructor:
    """SlideGraph+ style graph construction over patch features."""

    @staticmethod
    def _pca_reducer(graph: dict) -> np.ndarray:
        """Reduce node features to 3D [0,1] values (fast linear option)."""
        x = np.asarray(graph["x"], dtype=float)
        x = x - x.mean(axis=0)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        reduced = x @ vt[:3].T
        if reduced.shape[1] < 3:
            reduced = np.pad(reduced, ((0, 0), (0, 3 - reduced.shape[1])))
        reduced -= reduced.min(axis=0)
        ranges = reduced.max(axis=0)
        ranges[ranges == 0] = 1
        return reduced / ranges

    @staticmethod
    def _umap_reducer(graph: dict) -> np.ndarray:
        """UMAP node features → 3D [0,1] colors (reference
        ``tools/graph.py:214-230``; own UMAP — no umap-learn in env)."""
        from tiatoolbox_tpu_torch.tools.umap_lite import UMAP

        reduced = UMAP(n_components=3, random_state=0).fit_transform(
            np.asarray(graph["x"], dtype=float)
        )
        reduced -= reduced.min(axis=0)
        ranges = reduced.max(axis=0)
        ranges[ranges == 0] = 1
        return reduced / ranges

    @staticmethod
    def build(
        points: np.ndarray,
        features: np.ndarray,
        lambda_d: float = 3.0e-3,
        lambda_f: float = 1.0e-3,
        lambda_h: float = 0.8,
        connectivity_distance: int = 4000,
        neighbour_search_radius: int = 2000,
        feature_range_thresh: float | None = 1e-4,
    ) -> dict:
        """Cluster patches (spatial x feature similarity) → Delaunay graph.

        Returns {"x": cluster features, "edge_index": [2, M],
        "coordinates": cluster centroids}.
        """
        points = np.asarray(points)
        features = np.asarray(features)
        if feature_range_thresh:
            feature_ranges = features.max(axis=0) - features.min(axis=0)
            features = features[:, feature_ranges > feature_range_thresh]

        kd_tree = cKDTree(points)
        dists, idxs = kd_tree.query(x=points, k=len(points))

        n = len(points)
        condensed = np.zeros(n * (n - 1) // 2)
        index = 0
        for i in range(n - 1):
            neigh_d = dists[i][dists[i] < neighbour_search_radius]
            neigh_i = idxs[i][: len(neigh_d)]
            f_sim = np.exp(
                -lambda_f * np.linalg.norm(features[i] - features[neigh_i], axis=1)
            )
            d_sim = np.exp(-lambda_d * neigh_d)
            similarities = 1 - f_sim * d_sim
            i_vs_all = np.ones(n)
            i_vs_all[neigh_i] = similarities
            tail = i_vs_all[i + 1 :]
            condensed[index : index + len(tail)] = tail
            index += len(tail)

        linkage = hierarchy.linkage(condensed, method="average")
        clusters = hierarchy.fcluster(linkage, lambda_h, criterion="distance")

        point_centroids, feature_centroids = [], []
        for c in sorted(set(clusters)):
            (idx,) = np.where(clusters == c)
            point_centroids.append(np.round(points[idx].mean(axis=0)))
            feature_centroids.append(features[idx].mean(axis=0))
        point_centroids = np.array(point_centroids)
        feature_centroids = np.array(feature_centroids)

        adjacency = delaunay_adjacency(point_centroids, connectivity_distance)
        edge_index = affinity_to_edge_index(adjacency)
        return {
            "x": feature_centroids,
            "edge_index": edge_index,
            "coordinates": point_centroids,
        }

    @classmethod
    def visualise(cls, graph: dict, color=None, node_size: int = 25, edge_color=(0, 0, 0), ax=None):  # noqa: ARG003
        """Plot the graph with matplotlib (JAX :283-319): not ported.

        Raises:
            NotImplementedError: always; the port has no matplotlib. Draw onto
                an image with ``utils.visualization.plot_graph`` instead.
        """
        msg = (
            "SlideGraphConstructor.visualise draws with matplotlib, which the port does not have "
            "(ROADMAP.md section 1 item 8); utils.visualization.plot_graph draws a graph onto an image."
        )
        raise NotImplementedError(msg)
