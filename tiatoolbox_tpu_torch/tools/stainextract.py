"""Stain-matrix extraction (counterpart of ``tiatoolbox_tpu/tools/stainextract.py``).

``CustomExtractor`` (:43), ``RuifrokExtractor`` (:56), ``MacenkoExtractor``
(:66) and ``VahadaneExtractor`` (:104-138), with ``dl_output_for_h_and_e``
(:36-40), copied: estimation runs once per image in float64 on the host.
Vahadane's dictionary learning is the port's numpy copy of scikit-learn's
(``tools/_dict_learning.py``). The per-tile application of the matrices is
the kernel in ``tiatoolbox_tpu_torch.ops.stain``.
"""

from __future__ import annotations

import numpy as np

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.tools._dict_learning import dict_learning
from tiatoolbox_tpu_torch.utils.misc import get_luminosity_tissue_mask
from tiatoolbox_tpu_torch.utils.transforms import rgb2od

RUIFROK_HE = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])


def vectors_in_correct_direction(e_vectors: np.ndarray) -> np.ndarray:
    """Flip eigenvector signs so the first components are positive."""
    if e_vectors[0, 0] < 0:
        e_vectors[:, 0] *= -1
    if e_vectors[0, 1] < 0:
        e_vectors[:, 1] *= -1
    return e_vectors


def h_and_e_in_right_order(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Order two stain vectors with haematoxylin first (larger red OD)."""
    if v1[0] > v2[0]:
        return np.array([v1, v2])
    return np.array([v2, v1])


def dl_output_for_h_and_e(dictionary: np.ndarray) -> np.ndarray:
    """Order dictionary-learning atoms with H first."""
    if dictionary[0, 0] < dictionary[1, 0]:
        return dictionary[[1, 0], :]
    return dictionary


class CustomExtractor:
    """User-defined stain matrix (2x3 or 3x3)."""

    def __init__(self, stain_matrix: np.ndarray) -> None:
        self.stain_matrix = np.asarray(stain_matrix)
        if self.stain_matrix.shape not in ((2, 3), (3, 3)):
            msg = "Stain matrix must have shape (2, 3) or (3, 3)."
            raise ValueError(msg)

    def get_stain_matrix(self, _: np.ndarray) -> np.ndarray:
        return self.stain_matrix


class RuifrokExtractor:
    """Fixed H&E matrix of Ruifrok & Johnston (2001)."""

    def __init__(self) -> None:
        self.__stain_matrix = RUIFROK_HE.copy()

    def get_stain_matrix(self, _: np.ndarray) -> np.ndarray:
        return self.__stain_matrix.copy()


class MacenkoExtractor:
    """Macenko (2009) stain estimation: OD eigenbasis + angular percentiles.

    Args:
        luminosity_threshold: LAB-luminosity tissue-selection threshold.
        angular_percentile: Percentile of angular coordinates used for
            the extreme stain directions.
    """

    def __init__(
        self,
        luminosity_threshold: float = 0.8,
        angular_percentile: float = 99,
    ) -> None:
        self.__luminosity_threshold = luminosity_threshold
        self.__angular_percentile = angular_percentile

    def get_stain_matrix(self, img: np.ndarray) -> np.ndarray:
        img = img.astype("uint8")
        tissue_mask = get_luminosity_tissue_mask(
            img, threshold=self.__luminosity_threshold
        ).reshape((-1,))
        img_od = rgb2od(img).reshape((-1, 3))[tissue_mask]

        _, eigen_vectors = np.linalg.eigh(np.cov(img_od, rowvar=False))
        eigen_vectors = eigen_vectors[:, [2, 1]]  # two principal directions
        eigen_vectors = vectors_in_correct_direction(eigen_vectors)

        proj = img_od @ eigen_vectors
        phi = np.arctan2(proj[:, 1], proj[:, 0])
        min_phi = np.percentile(phi, 100 - self.__angular_percentile)
        max_phi = np.percentile(phi, self.__angular_percentile)
        v1 = eigen_vectors @ np.array([np.cos(min_phi), np.sin(min_phi)])
        v2 = eigen_vectors @ np.array([np.cos(max_phi), np.sin(max_phi)])
        he = h_and_e_in_right_order(v1, v2)
        return he / np.linalg.norm(he, axis=1)[:, None]


class VahadaneExtractor:
    """Vahadane (2016) sparse-NMF stain estimation (dictionary learning).

    Args:
        luminosity_threshold: LAB-luminosity tissue-selection threshold.
        regularizer: The Lasso penalty of the dictionary learning.
    """

    def __init__(
        self,
        luminosity_threshold: float = 0.8,
        regularizer: float = 0.1,
    ) -> None:
        logger.warning(
            "Vahadane stain extraction results depend on the dictionary "
            "learning implementation and may be unstable across library "
            "versions; consider Macenko for reproducibility.",
        )
        self.__luminosity_threshold = luminosity_threshold
        self.__regularizer = regularizer

    def get_stain_matrix(self, img: np.ndarray) -> np.ndarray:
        img = img.astype("uint8")
        tissue_mask = get_luminosity_tissue_mask(
            img, threshold=self.__luminosity_threshold
        ).reshape((-1,))
        img_od = rgb2od(img).reshape((-1, 3))[tissue_mask]
        # DictionaryLearning(n_components=2, alpha=regularizer, max_iter=3,
        # transform_max_iter=1000, positive_dict=True).fit_transform
        dictionary = dict_learning(img_od.T, self.__regularizer)[0].T
        dictionary = dl_output_for_h_and_e(dictionary)
        return dictionary / np.linalg.norm(dictionary, axis=1)[:, None]
