"""Evaluation metrics (counterpart of ``tiatoolbox_tpu/utils/metrics.py``).

``pair_coordinates`` (:10), ``f1_detection`` (:34) and ``dice`` (:43) are
JAX's, copied as they are: numpy and scipy only.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial import distance


def pair_coordinates(
    set_a: np.ndarray,
    set_b: np.ndarray,
    radius: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Optimally pair points between two sets within a radius.

    Uses the Hungarian algorithm (Munkres) on the pairwise Euclidean
    distance matrix. Returns (pairing, unpaired_a, unpaired_b) where
    pairing is an Nx2 array of (index_a, index_b).
    """
    pair_distance = distance.cdist(set_a, set_b, metric="euclidean")
    indices_a, paired_indices_b = linear_sum_assignment(pair_distance)
    pair_cost = pair_distance[indices_a, paired_indices_b]

    paired_a = indices_a[pair_cost <= radius]
    paired_b = paired_indices_b[pair_cost <= radius]

    pairing = np.concatenate([paired_a[:, None], paired_b[:, None]], axis=-1)
    unpaired_a = np.delete(np.arange(set_a.shape[0]), paired_a)
    unpaired_b = np.delete(np.arange(set_b.shape[0]), paired_b)
    return pairing, unpaired_a, unpaired_b


def f1_detection(true: np.ndarray, pred: np.ndarray, radius: float) -> float:
    """F1 for detection via paired coordinates within a radius."""
    (paired_true, unpaired_true, unpaired_pred) = pair_coordinates(true, pred, radius)
    tp = len(paired_true)
    fp = len(unpaired_pred)
    fn = len(unpaired_true)
    return tp / (tp + 0.5 * fp + 0.5 * fn)


def dice(gt_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    """Soerensen-Dice coefficient between two boolean masks."""
    if gt_mask.shape != pred_mask.shape:
        msg = f"{'Shape mismatch between the two masks.'}"
        raise ValueError(msg)
    gt_mask = gt_mask.astype(bool)
    pred_mask = pred_mask.astype(bool)
    sum_masks = gt_mask.sum() + pred_mask.sum()
    if sum_masks == 0:
        return np.nan
    return 2 * np.logical_and(gt_mask, pred_mask).sum() / sum_masks
