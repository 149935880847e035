"""Minimal UMAP (counterpart of ``tiatoolbox_tpu/tools/umap_lite.py``).

UMAP as JAX's ``UMAP`` (:22-182) runs it, on numpy and scipy on the host: a
kNN fuzzy simplicial set with per-point bandwidths, a spectral start and
batched negative-sampling epochs. Two things differ. The neighbour search:
JAX asks scikit-learn's ``NearestNeighbors``, the port scipy's
``cKDTree.query(k + 1)``. Their distances can differ in the last bits (and
points at equal distances may come in another order), so the fuzzy graph
matches JAX's to about 1e-6 and not bit for bit. The eigensolver starts
from a fixed vector where JAX lets ARPACK draw one (ARPACK's state runs on
between calls, so JAX's seeded output is not repeatable in one process);
the port's output is. From the same graph and spectral start every epoch is
JAX's to the bit, with the random draws taken from
``default_rng(random_state)`` in JAX's order.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import eigsh
from scipy.spatial import cKDTree

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def _smooth_knn_dist(distances: np.ndarray, k: float, n_iter: int = 64):
    """Per-point (sigma, rho) so that sum exp(-(d-rho)/sigma) = log2(k)."""
    target = np.log2(k)
    rho = np.zeros(distances.shape[0])
    sigma = np.zeros(distances.shape[0])
    mean_all = distances.mean()
    for i in range(distances.shape[0]):
        row = distances[i]
        non_zero = row[row > 0.0]
        rho[i] = non_zero[0] if non_zero.size else 0.0
        lo, hi, mid = 0.0, np.inf, 1.0
        for _ in range(n_iter):
            psum = np.sum(np.exp(-np.maximum(row[1:] - rho[i], 0.0) / mid))
            if abs(psum - target) < SMOOTH_K_TOLERANCE:
                break
            if psum > target:
                hi = mid
                mid = (lo + hi) / 2.0
            else:
                lo = mid
                mid = mid * 2.0 if hi == np.inf else (lo + hi) / 2.0
        sigma[i] = max(mid, MIN_K_DIST_SCALE * (non_zero.mean() if non_zero.size else mean_all))
    return sigma, rho


def nearest_neighbors(x: np.ndarray, n_neighbors: int) -> tuple[np.ndarray, np.ndarray]:
    """Distances and indices of each point's ``min(n_neighbors, n - 1) + 1``
    nearest points, itself first (``NearestNeighbors.kneighbors`` of JAX :371-372)."""
    k = min(n_neighbors, x.shape[0] - 1)
    dists, idx = cKDTree(np.asarray(x, np.float64)).query(x, k=k + 1)
    return dists, idx


def _fuzzy_simplicial_set(x: np.ndarray, n_neighbors: int):
    dists, idx = nearest_neighbors(x, n_neighbors)
    return fuzzy_simplicial_set_from_knn(dists, idx)


def fuzzy_simplicial_set_from_knn(dists: np.ndarray, idx: np.ndarray):
    """The symmetrised fuzzy graph of a kNN table (JAX :366-382 after the search)."""
    n = dists.shape[0]
    k = dists.shape[1] - 1
    sigma, rho = _smooth_knn_dist(dists, k + 1)
    rows = np.repeat(np.arange(n), k)
    cols = idx[:, 1:].ravel()
    vals = np.exp(
        -np.maximum(dists[:, 1:] - rho[:, None], 0.0) / sigma[:, None]
    ).ravel()
    a = sparse.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    at = a.T
    # probabilistic t-conorm symmetrization: a + a' - a∘a'
    return (a + at - a.multiply(at)).tocoo()


def _spectral_init(graph, n_components: int, rng) -> np.ndarray:
    n = graph.shape[0]
    deg = np.asarray(graph.sum(axis=1)).ravel()
    deg[deg == 0] = 1.0
    d_inv_sqrt = sparse.diags(1.0 / np.sqrt(deg))
    lap = sparse.identity(n) - d_inv_sqrt @ graph @ d_inv_sqrt
    # JAX leaves the start vector to ARPACK, whose random state runs on from
    # call to call in a process, so JAX's own embedding changes between two
    # calls with one seed; the port starts from a fixed vector and repeats.
    v0 = np.random.default_rng(0).uniform(-1.0, 1.0, n)
    try:
        _vals, vecs = eigsh(
            lap, k=n_components + 1, which="SM", tol=1e-4, maxiter=n * 20, v0=v0
        )
        emb = vecs[:, 1 : n_components + 1]
        expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
        return emb * expansion + rng.normal(0, 1e-4, emb.shape)
    except Exception:  # eigensolver failure: random fallback
        return rng.uniform(-10, 10, (n, n_components))


def _find_ab_params(spread: float, min_dist: float):
    """Least-squares fit of the (a, b) differentiable-curve params."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(
        xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread)
    )
    (a, b), _ = curve_fit(curve, xv, yv)
    return a, b


class UMAP:
    """Drop-in subset of ``umap.UMAP`` (fit_transform only).

    Args mirror umap-learn defaults where implemented.
    """

    def __init__(
        self,
        n_components: int = 2,
        n_neighbors: int = 15,
        min_dist: float = 0.1,
        spread: float = 1.0,
        n_epochs: int | None = None,
        learning_rate: float = 1.0,
        negative_sample_rate: int = 5,
        random_state: int | None = None,
    ) -> None:
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate
        self.random_state = random_state

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if n <= self.n_components:
            return np.zeros((n, self.n_components), np.float32)
        rng = np.random.default_rng(self.random_state)
        graph = _fuzzy_simplicial_set(x, self.n_neighbors)
        emb = _spectral_init(graph.tocsr(), self.n_components, rng).astype(
            np.float32
        )
        a, b = _find_ab_params(self.spread, self.min_dist)
        n_epochs = self.n_epochs or (500 if n < 10_000 else 200)

        # per-edge epoch scheduling as in umap-learn
        weights = graph.data
        heads, tails = graph.row, graph.col
        # umap-learn's make_epochs_per_sample: an edge of weight w fires
        # every max(w)/w epochs (strongest edges every epoch).
        epochs_per_sample = np.full(weights.shape, np.inf)
        mask = weights > 0
        epochs_per_sample[mask] = weights[mask].max() / weights[mask]
        epoch_of_next = epochs_per_sample.copy()
        neg_rate = self.negative_sample_rate

        # Batched epoch updates (scatter-accumulated with np.add.at):
        # within an epoch every active edge sees the epoch-start
        # embedding instead of strictly-sequential SGD — the layout
        # objective and negative-sampling schedule are unchanged, and
        # the vectorized form is ~100x the pure-python edge loop on
        # realistic slide graphs (10k nodes / 100k+ edges).
        for epoch in range(n_epochs):
            alpha = self.learning_rate * (1.0 - epoch / n_epochs)
            active = np.nonzero(epoch_of_next <= epoch)[0]
            if len(active) == 0:
                continue
            i = heads[active]
            j = tails[active]
            diff = emb[i] - emb[j]
            d2 = (diff * diff).sum(axis=1)
            coeff = np.zeros_like(d2)
            pos = d2 > 0.0
            coeff[pos] = (-2.0 * a * b * d2[pos] ** (b - 1.0)) / (
                a * d2[pos] ** b + 1.0
            )
            g = np.clip(coeff[:, None] * diff, -4.0, 4.0) * alpha
            np.add.at(emb, i, g)
            np.add.at(emb, j, -g)
            # negative samples, all drawn at once
            ei = np.repeat(i, neg_rate)
            ek = rng.integers(n, size=ei.shape[0])
            diffn = emb[ei] - emb[ek]
            d2n = (diffn * diffn).sum(axis=1)
            cn = np.zeros_like(d2n)
            m = (ei != ek) & (d2n > 0.0)
            cn[m] = (2.0 * b) / ((0.001 + d2n[m]) * (a * d2n[m] ** b + 1.0))
            gn = np.clip(cn[:, None] * diffn, -4.0, 4.0) * alpha
            np.add.at(emb, ei, gn)
            epoch_of_next[active] += epochs_per_sample[active]
        return emb
