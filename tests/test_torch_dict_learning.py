"""The port's numpy dictionary learning against scikit-learn's.

``tiatoolbox_tpu_torch/tools/_dict_learning.py`` copies what Vahadane takes
from scikit-learn 1.9: ``lars_path_gram`` with ``method="lasso"`` (LARS with
Lasso drops, the Cholesky down-date), the LassoLars sparse coding and
``DictionaryLearning(n_components=2, fit_algorithm="lars", positive_dict=True,
max_iter=3, transform_max_iter=1000).fit_transform``, the one setting
``VahadaneExtractor`` uses. Each is fed the same seeded random problems as
scikit-learn and held within 1e-8 relative (on the largest coefficient).
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
from sklearn.decomposition import DictionaryLearning as SkDictionaryLearning
from sklearn.decomposition import sparse_encode
from sklearn.linear_model import lars_path_gram as sk_lars_path_gram

from tiatoolbox_tpu_torch.tools import _dict_learning as port

REL_TOL = 1e-8


def _close(got: np.ndarray, want: np.ndarray) -> None:
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= REL_TOL * scale


def _sk_lars(xy, gram, n_samples, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sk_lars_path_gram(xy, gram, n_samples=n_samples, max_iter=port.LARS_MAX_ITER, method="lasso",
                                 **kwargs)


@pytest.mark.parametrize("seed", range(12))
def test_lars_path_gram_against_sklearn(seed) -> None:
    rng = np.random.default_rng(seed)
    n_features = int(rng.integers(2, 9))
    x = rng.random((60, n_features))
    if seed % 3 == 0:  # two nearly collinear columns
        x[:, 1] = x[:, 0] + 1e-3 * rng.random(60)
    y = rng.random(60) - (0.5 if seed % 2 else 0.0)
    gram, xy = x.T @ x, x.T @ y
    for alpha_min in (0.0, 1e-4, 0.01, float(rng.uniform(0, 0.05))):
        want = _sk_lars(xy, gram, 60, alpha_min=alpha_min, return_path=False, return_n_iter=True)
        got = port.lars_path_gram(xy, gram, 60, alpha_min=alpha_min)
        _close(got[2], want[2])
        assert got[1] == list(want[1]) and got[3] == want[3]
        assert got[0] == pytest.approx(float(want[0][0] if np.ndim(want[0]) else want[0]), rel=REL_TOL)


def test_lasso_drops_a_variable_as_sklearn() -> None:
    """A path on which Lasso drops a variable (the Cholesky down-date)."""
    rng = np.random.default_rng(0)
    found = 0
    for _ in range(400):
        x = rng.normal(size=(30, 6))
        y = x @ rng.normal(size=6) + 0.1 * rng.normal(size=30)
        gram, xy = x.T @ x, x.T @ y
        _, _, path = _sk_lars(xy, gram, 30)
        steps = int(np.sum(np.abs(path[:, 1:]) > 0, axis=0).max())
        if path.shape[1] - 1 <= steps:
            continue  # no drop on this path
        found += 1
        want = _sk_lars(xy, gram, 30, return_path=False, return_n_iter=True)
        got = port.lars_path_gram(xy, gram, 30)
        _close(got[2], want[2])
        assert got[3] == want[3]
        if found >= 5:
            break
    assert found >= 1


@pytest.mark.parametrize("seed", range(4))
def test_sparse_encode_against_sklearn(seed) -> None:
    rng = np.random.default_rng(seed + 100)
    x = rng.random((3, 500))
    dictionary = rng.random((2, 500))
    dictionary /= np.linalg.norm(dictionary, axis=1, keepdims=True)
    want = sparse_encode(x, dictionary, algorithm="lasso_lars", alpha=0.1, max_iter=port.LARS_MAX_ITER)
    _close(port.sparse_encode_lasso_lars(x, dictionary, 0.1), want)


# (tissue pixel count, regularizer): Vahadane's [3, n] data from one pixel
# (rank 1: scikit-learn pads the second atom with zeros) to thousands
DL_CASES = [(1, 0.1), (2, 0.1), (3, 0.1), (7, 0.1), (50, 0.1), (300, 0.1), (1000, 0.1), (2999, 0.1),
            (120, 0.5), (800, 0.02), (4096, 0.1), (64, 1.0)]


@pytest.mark.parametrize(("n_features", "alpha"), DL_CASES)
@pytest.mark.parametrize("seed", range(2))
def test_dictionary_learning_against_sklearn(n_features, alpha, seed) -> None:
    """Vahadane's call on random positive problems: 3 samples (the channels),
    as many features as tissue pixels, optical densities up to about 2."""
    rng = np.random.default_rng(seed * 1000 + n_features)
    x = rng.random((3, n_features)) * rng.uniform(0.1, 2.0)
    sk = SkDictionaryLearning(n_components=port.N_COMPONENTS, alpha=alpha, fit_algorithm="lars",
                              positive_dict=True, max_iter=port.MAX_ITER, tol=port.TOL,
                              transform_max_iter=port.LARS_MAX_ITER)
    np.random.seed(seed)  # an atom left unused is redrawn from numpy's global RandomState
    want = sk.fit_transform(x)
    np.random.seed(seed)
    code, dictionary, errors, n_iter = port.dict_learning(x, alpha)
    _close(code, want)
    _close(dictionary, sk.components_)
    assert n_iter == sk.n_iter_
    np.testing.assert_allclose(errors, sk.error_, rtol=REL_TOL)


def test_svd_flip_against_sklearn() -> None:
    from sklearn.utils.extmath import svd_flip

    rng = np.random.default_rng(1)
    u, _, v = np.linalg.svd(rng.normal(size=(4, 7)), full_matrices=False)
    want = svd_flip(u.copy(), v.copy())
    got = port.svd_flip(u.copy(), v.copy())
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
