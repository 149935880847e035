"""Dictionary learning for Vahadane stain extraction, in numpy and scipy.

JAX's ``VahadaneExtractor`` (``tiatoolbox_tpu/tools/stainextract.py:121-138``)
calls scikit-learn's ``DictionaryLearning(n_components=2, alpha=regularizer,
fit_algorithm="lars", positive_dict=True, max_iter=3,
transform_max_iter=1000).fit_transform``; the port's extractor has no
scikit-learn, so this module follows the code that call runs, at those
settings only (scikit-learn 1.9, ``sklearn/decomposition/_dict_learning.py``
and ``sklearn/linear_model/_least_angle.py``):

- ``dict_learning`` is ``_dict_learning`` (:551): the code and dictionary
  start from ``scipy.linalg.svd`` with ``svd_flip``'s sign rule (:578-580),
  then each of at most 3 iterations sparse-codes the data and updates the
  dictionary, stopping early on a relative cost decrease under 1e-8;
- ``sparse_encode_lasso_lars`` is ``_sparse_encode_precomputed`` (:118-135):
  one ``LassoLars(alpha / n_features, fit_intercept=False)`` problem per
  sample on the precomputed Gram matrix and covariance;
- ``lars_path_gram`` is ``_lars_path_solver`` on a Gram matrix with
  ``method="lasso"`` and ``return_path=False``: LARS with Lasso drops, the
  Cholesky factor updated with ``potrs``/``solve_triangular`` and downdated
  with Givens rotations (``sklearn/utils/arrayfuncs.pyx``
  ``cholesky_delete``), ties broken by the first maximum as ``np.argmax``
  does;
- ``update_dict`` is ``_update_dict`` (:471) with ``positive=True``
  (:541): block coordinate descent on the atoms, each clipped at zero and
  projected into the unit ball, an unused atom redrawn from the data with
  numpy's global ``RandomState`` (scikit-learn's ``random_state=None``).

In Vahadane's call the data is ``img_od.T``: 3 samples (the channels), each
as long as the tissue pixel count, so each Lasso problem has 2 features.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg
from scipy.linalg.blas import drot, drotg
from scipy.linalg.lapack import get_lapack_funcs

_EPS = np.finfo(float).eps
_TINY32 = np.finfo(np.float32).tiny
_EQUALITY_TOL = np.finfo(np.float32).eps
_COV_PRECISION = np.finfo(np.float64).precision
# VahadaneExtractor's DictionaryLearning settings
N_COMPONENTS = 2
MAX_ITER = 3
TOL = 1e-8
LARS_MAX_ITER = 1000  # transform_max_iter, the most LARS steps a sample


def _min_pos(x: np.ndarray) -> float:
    """Smallest positive entry, or the largest float64 when none is positive."""
    pos = x[x > 0]
    return float(pos.min()) if pos.size else float(np.finfo(np.float64).max)


def _cholesky_delete(factor: np.ndarray, go_out: int) -> None:
    """Remove row and column ``go_out`` from a lower Cholesky factor in place."""
    n = factor.shape[0]
    for i in range(go_out, n - 1):
        factor[i, : i + 2] = factor[i + 1, : i + 2]
    for i in range(go_out, n - 1):
        a, b = factor[i, i], factor[i, i + 1]
        c, s = drotg(a, b)
        factor[i, i] = c * a + s * b  # BLAS rotg's r
        if factor[i, i] < 0:
            factor[i, i] = abs(factor[i, i])
            c, s = -c, -s
        factor[i, i + 1] = 0.0
        if n - i - 2 > 0:
            x, y = drot(factor[i + 1 :, i], factor[i + 1 :, i + 1], c, s)
            factor[i + 1 :, i], factor[i + 1 :, i + 1] = x, y


def lars_path_gram(  # noqa: C901, PLR0912, PLR0915
    xy: np.ndarray,
    gram: np.ndarray,
    n_samples: int,
    alpha_min: float = 0.0,
) -> tuple[float, list[int], np.ndarray, int]:
    """Lasso by LARS on a Gram matrix: the end of the path at ``alpha_min``.

    Args:
        xy: ``X.T @ y``, shape ``[n_features]``.
        gram: ``X.T @ X``, shape ``[n_features, n_features]``.
        n_samples: The sample count; alpha is the largest correlation over it.
        alpha_min: The regularisation at which the path stops.

    Returns:
        (alpha, active indices, coefficients, steps), as scikit-learn's
        ``lars_path_gram(..., max_iter=1000, method="lasso",
        return_path=False, return_n_iter=True)``.
    """
    cov = np.array(xy, dtype=np.float64)
    gram = np.array(gram, dtype=np.float64)
    n_features = cov.shape[0]
    max_iter, eps = LARS_MAX_ITER, _EPS
    max_features = min(max_iter, n_features)
    coef = np.zeros(n_features)
    prev_coef = np.zeros(n_features)
    alpha = np.array([0.0])
    prev_alpha = np.array([0.0])
    n_iter, n_active = 0, 0
    active: list[int] = []
    indices = np.arange(n_features)
    sign_active = np.empty(max_features, dtype=np.int8)
    drop = False
    factor = np.empty((max_features, max_features))
    (solve_cholesky,) = get_lapack_funcs(("potrs",), (factor,))
    gram_copy = gram.copy()
    cov_copy = cov.copy()
    idx = np.empty(0, np.int64)

    while True:
        if cov.size:
            c_idx = int(np.argmax(np.abs(cov)))
            c_ = cov[c_idx]
            c = np.fabs(c_)
        else:
            c = 0.0
        alpha[0] = c / n_samples
        if alpha[0] <= alpha_min + _EQUALITY_TOL:
            if abs(alpha[0] - alpha_min) > _EQUALITY_TOL:
                if n_iter > 0:
                    ss = (prev_alpha[0] - alpha_min) / (prev_alpha[0] - alpha[0])
                    coef[:] = prev_coef + ss * (coef - prev_coef)
                alpha[0] = alpha_min
            break
        if n_iter >= max_iter or n_active >= n_features:
            break
        if not drop:
            sign_active[n_active] = np.sign(c_)
            m, n = n_active, c_idx + n_active
            cov[c_idx], cov[0] = cov[0], cov[c_idx]
            indices[n], indices[m] = indices[m], indices[n]
            cov_not_shortened = cov
            cov = cov[1:]
            gram[[m, n]] = gram[[n, m]]
            gram[:, [m, n]] = gram[:, [n, m]]
            c_diag = gram[n_active, n_active]
            factor[n_active, :n_active] = gram[n_active, :n_active]
            if n_active:
                factor[n_active, :n_active] = linalg.solve_triangular(
                    factor[:n_active, :n_active],
                    factor[n_active, :n_active],
                    trans=0,
                    lower=1,
                    check_finite=False,
                )
            v = np.dot(factor[n_active, :n_active], factor[n_active, :n_active])
            diag = max(np.sqrt(np.abs(c_diag - v)), eps)
            factor[n_active, n_active] = diag
            if diag < 1e-7:
                # degenerate regressor: drop it from the candidates
                cov = cov_not_shortened
                cov[0] = 0
                cov[c_idx], cov[0] = cov[0], cov[c_idx]
                continue
            active.append(int(indices[n_active]))
            n_active += 1

        if n_iter > 0 and prev_alpha[0] < alpha[0]:
            # residues small, alpha no longer controlled: stop early
            break

        least_squares, _ = solve_cholesky(
            factor[:n_active, :n_active], sign_active[:n_active], lower=True
        )
        if least_squares.size == 1 and least_squares == 0:
            least_squares[...] = 1
            aa = 1.0
        else:
            aa = 1.0 / np.sqrt(np.sum(least_squares * sign_active[:n_active]))
            if not np.isfinite(aa):
                i = 0
                factor_ = factor[:n_active, :n_active].copy()
                while not np.isfinite(aa):
                    factor_.flat[:: n_active + 1] += (2**i) * eps
                    least_squares, _ = solve_cholesky(factor_, sign_active[:n_active], lower=True)
                    tmp = max(np.sum(least_squares * sign_active[:n_active]), eps)
                    aa = 1.0 / np.sqrt(tmp)
                    i += 1
            least_squares *= aa

        corr_eq_dir = np.dot(gram[:n_active, n_active:].T, least_squares)
        np.around(corr_eq_dir, decimals=_COV_PRECISION, out=corr_eq_dir)
        g1 = _min_pos((c - cov) / (aa - corr_eq_dir + _TINY32))
        g2 = _min_pos((c + cov) / (aa + corr_eq_dir + _TINY32))
        gamma_ = min(g1, g2, c / aa)

        drop = False
        z = -coef[active] / (least_squares + _TINY32)
        z_pos = _min_pos(z)
        if z_pos < gamma_:
            idx = np.where(z == z_pos)[0][::-1]
            sign_active[idx] = -sign_active[idx]
            gamma_ = z_pos
            drop = True

        n_iter += 1
        prev_coef = coef
        prev_alpha[0] = alpha[0]
        coef = np.zeros_like(coef)
        coef[active] = prev_coef[active] + gamma_ * least_squares
        cov -= gamma_ * corr_eq_dir

        if drop:
            for ii in idx:
                _cholesky_delete(factor[:n_active, :n_active], int(ii))
            n_active -= 1
            drop_idx = [active.pop(ii) for ii in idx]
            for ii in idx:
                for i in range(ii, n_active):
                    indices[i], indices[i + 1] = indices[i + 1], indices[i]
                    gram[[i, i + 1]] = gram[[i + 1, i]]
                    gram[:, [i, i + 1]] = gram[:, [i + 1, i]]
            temp = cov_copy[drop_idx] - np.dot(gram_copy[drop_idx], coef)
            cov = np.r_[temp, cov]
            sign_active = np.delete(sign_active, idx)
            sign_active = np.append(sign_active, 0.0)
    return float(alpha[0]), active, coef, n_iter


def sparse_encode_lasso_lars(x: np.ndarray, dictionary: np.ndarray, alpha: float) -> np.ndarray:
    """Lasso codes ``[n_samples, n_components]`` of ``x`` on ``dictionary``.

    Each sample's problem is ``LassoLars(alpha / n_features,
    fit_intercept=False)`` on the Gram matrix ``dictionary @ dictionary.T``.
    """
    n_features = x.shape[1]
    gram = np.dot(dictionary, dictionary.T)
    cov = np.dot(dictionary, x.T)
    code = np.empty((x.shape[0], dictionary.shape[0]))
    with np.errstate(all="ignore"):
        for k in range(x.shape[0]):
            _, _, code[k], _ = lars_path_gram(cov[:, k], gram, n_samples=n_features, alpha_min=alpha / n_features)
    return code


def svd_flip(u: np.ndarray, v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Signs of ``u``'s columns (and ``v``'s rows) so each column's largest
    magnitude entry is positive."""
    signs = np.sign(u[np.argmax(np.abs(u), axis=0), range(u.shape[1])])
    return u * signs, v * signs[:, None]


def update_dict(dictionary: np.ndarray, y: np.ndarray, code: np.ndarray) -> None:
    """One block coordinate descent sweep over the atoms, in place, each atom
    clipped at zero (``positive_dict=True``)."""
    n_samples, n_components = code.shape
    gram = code.T @ code
    proj = y.T @ code
    random_state = np.random.mtrand._rand  # noqa: SLF001 - scikit-learn's random_state=None
    for k in range(n_components):
        if gram[k, k] > 1e-6:
            dictionary[k] += (proj[:, k] - gram[k] @ dictionary) / gram[k, k]
        else:
            newd = y[random_state.choice(n_samples)]
            noise_level = 0.01 * (newd.std() or 1)
            noise = random_state.normal(0, noise_level, size=len(newd))
            dictionary[k] = newd + noise
            code[:, k] = 0
        np.clip(dictionary[k], 0, None, out=dictionary[k])
        dictionary[k] /= max(linalg.norm(dictionary[k]), 1)


def dict_learning(x: np.ndarray, alpha: float) -> tuple[np.ndarray, np.ndarray, list[float], int]:
    """Sparse code and dictionary of ``x`` (``[n_samples, n_features]``) with
    Vahadane's settings; the code is ``DictionaryLearning.fit_transform(x)``.

    Returns:
        (code ``[n_samples, 2]``, dictionary ``[2, n_features]``, the cost
        after each iteration, the iteration count).
    """
    x = np.asarray(x, dtype=np.float64)
    code, s, dictionary = linalg.svd(x, full_matrices=False)
    code, dictionary = svd_flip(code, dictionary)
    dictionary = s[:, None] * dictionary
    # rank 1 (a single tissue pixel) leaves the second atom at zero, as
    # scikit-learn pads it; otherwise keep the two leading components
    pad = max(N_COMPONENTS - len(dictionary), 0)
    code = np.pad(code, ((0, 0), (0, pad)))[:, :N_COMPONENTS]
    dictionary = np.asfortranarray(np.pad(dictionary, ((0, pad), (0, 0)))[:N_COMPONENTS])
    errors: list[float] = []
    ii = -1
    for ii in range(MAX_ITER):  # noqa: B007 - the count is returned
        code = sparse_encode_lasso_lars(x, dictionary, alpha)
        update_dict(dictionary, x, code)
        cost = 0.5 * np.sum((x - code @ dictionary) ** 2) + alpha * np.sum(np.abs(code))
        errors.append(cost)
        if ii > 0 and errors[-2] - errors[-1] < TOL * errors[-1]:
            break
    return code, dictionary, errors, ii + 1
