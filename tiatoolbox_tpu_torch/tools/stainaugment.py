"""Stain augmentation (counterpart of ``tiatoolbox_tpu/tools/stainaugment.py``).

``StainAugmentor`` (:24-123) perturbs one image's stain concentrations on
the host in float64, with the same ``self.rng`` draws as JAX's, so both give
the same pixels from the same ``np.random.default_rng(seed)``.

``augment_tiles`` is the counterpart of the device program
``augment_tiles_jax`` (:129-154): one factor and one offset per tile and
stain, drawn with ``torch.rand`` from the caller's ``torch.Generator`` on the
tiles' device, then the port's kernel ``stain_augment`` (``csrc/stain.cu``)
rebuilds each tile from the perturbed concentrations. The draws differ from
``jax.random``'s, so equal seeds do not give equal tiles across packages.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.ops.stain import stain_augment
from tiatoolbox_tpu_torch.tools.stainextract import (
    CustomExtractor,
    MacenkoExtractor,
    VahadaneExtractor,
)


class StainAugmentor:
    """Augment the staining of an H&E image.

    Args:
        method: "vahadane", "macenko", or "custom" stain extraction.
        stain_matrix: Stain matrix for method="custom".
        sigma1: Multiplicative perturbation range (1 +- sigma1).
        sigma2: Additive perturbation range (+- sigma2).
        augment_background: Whether to perturb background pixels too.
        always_apply / p: albumentations-style application probability.
    """

    def __init__(
        self,
        method: str = "vahadane",
        stain_matrix: np.ndarray | None = None,
        sigma1: float = 0.4,
        sigma2: float = 0.2,
        p: float = 0.5,
        *,
        augment_background: bool = False,
        always_apply: bool = False,
    ) -> None:
        self.method = method.lower()
        self.sigma1 = sigma1
        self.sigma2 = sigma2
        self.augment_background = augment_background
        self.p = 1.0 if always_apply else p
        if self.method not in ("macenko", "vahadane", "custom"):
            msg = f"Unsupported stain extractor method {method!r} for StainAugmentor."
            raise ValueError(msg)
        if self.method == "custom" and stain_matrix is None:
            msg = '`stain_matrix` is None when using `method`="custom".'
            raise ValueError(msg)
        if self.method == "macenko":
            self.extractor = MacenkoExtractor()
        elif self.method == "vahadane":
            self.extractor = VahadaneExtractor()
        else:
            self.extractor = CustomExtractor(stain_matrix)
        self.stain_matrix: np.ndarray | None = None
        self.source_concentrations: np.ndarray | None = None
        self.img_shape: tuple | None = None
        self.tissue_mask: np.ndarray | None = None
        self.rng = np.random.default_rng()

    def fit(self, img: np.ndarray, threshold: float = 0.85) -> None:
        """Extract the stain matrix and concentrations of the image."""
        from tiatoolbox_tpu_torch.tools.stainnorm import StainNormalizer

        self.stain_matrix = self.extractor.get_stain_matrix(img)
        self.source_concentrations = StainNormalizer.get_concentrations(img, self.stain_matrix)
        self.n_stains = self.source_concentrations.shape[1]
        grey = img.mean(axis=-1) if img.ndim == 3 else img
        self.tissue_mask = (grey / 255.0) < threshold
        self.img_shape = img.shape

    def augment(self) -> np.ndarray:
        """One augmented image from the fitted concentrations."""
        augmented_concentrations = copy.deepcopy(self.source_concentrations)
        mask = self.tissue_mask.reshape(-1)
        for i in range(self.n_stains):
            alpha = self.rng.uniform(1 - self.sigma1, 1 + self.sigma1)
            beta = self.rng.uniform(-self.sigma2, self.sigma2)
            if self.augment_background:
                augmented_concentrations[:, i] *= alpha
                augmented_concentrations[:, i] += beta
            else:
                augmented_concentrations[mask, i] *= alpha
                augmented_concentrations[mask, i] += beta
        img_augmented = 255 * np.exp(-1 * np.dot(augmented_concentrations, self.stain_matrix))
        img_augmented = np.clip(img_augmented, 0, 255)
        return img_augmented.reshape(self.img_shape).astype(np.uint8)

    def apply(self, img: np.ndarray, **_kwargs) -> np.ndarray:
        """Fit and augment in one call (albumentations-compatible)."""
        self.fit(img.astype(np.uint8))
        return self.augment()

    def __call__(self, image: np.ndarray, **_kwargs) -> dict:
        """albumentations-style call: applied with probability p."""
        if self.rng.uniform() < self.p:
            return {"image": self.apply(image)}
        return {"image": image}

    def get_params(self) -> dict:
        """albumentations plugin API (JAX ``stainaugment.py:113-117``)."""
        self.alpha = self.rng.uniform(1 - self.sigma1, 1 + self.sigma1)
        self.beta = self.rng.uniform(-self.sigma2, self.sigma2)
        return {}

    def get_params_dependent_on_targets(self, params: dict) -> dict:  # noqa: ARG002
        """albumentations plugin API: no target-dependent parameters."""
        return {}

    @staticmethod
    def get_transform_init_args_names(**kwargs) -> tuple[str, ...]:  # noqa: ARG004
        """albumentations plugin API: the constructor's argument names."""
        return ("method", "stain_matrix", "sigma1", "sigma2", "augment_background")


def augment_tiles(
    tiles,
    stain_matrix: np.ndarray,
    generator: torch.Generator | None = None,
    sigma1: float = 0.4,
    sigma2: float = 0.2,
    device=None,
) -> torch.Tensor:
    """Stain-augment a uint8 tile batch with a factor and an offset per tile and stain.

    Args:
        tiles: uint8 ``[N, H, W, 3]`` tensor, or an array that goes to
            ``device`` first.
        stain_matrix: ``[S, 3]`` stain matrix (S = 2 or 3), fixed for all tiles.
        generator: The ``torch.Generator`` of the draws, on the tiles'
            device; torch's default generator when None.
        sigma1: Factors are uniform on ``[1 - sigma1, 1 + sigma1)``.
        sigma2: Offsets are uniform on ``[-sigma2, sigma2)``.
        device: Where an array goes; ``rcParam["device"]`` by default. A
            tensor stays where it is.

    Returns:
        uint8 tensor of the batch's shape on the tiles' device.
    """
    if not isinstance(tiles, torch.Tensor):
        tiles = torch.from_numpy(np.ascontiguousarray(tiles)).to(resolve_device(device))
    sm = np.asarray(stain_matrix, np.float64)
    proj = np.linalg.pinv(sm.T).T
    n, s = tiles.shape[0], sm.shape[0]
    alpha = torch.rand((n, s), generator=generator, device=tiles.device)
    alpha = alpha * (2 * sigma1) + (1 - sigma1)
    beta = torch.rand((n, s), generator=generator, device=tiles.device)
    beta = beta * (2 * sigma2) - sigma2
    return stain_augment(tiles.contiguous(), proj.astype(np.float32), sm.astype(np.float32), alpha, beta)
