"""Stain normalisation (counterpart of ``tiatoolbox_tpu/tools/stainnorm.py``).

``StainNormalizer`` (:26-120) with its Custom, Ruifrok, Macenko and
Vahadane (:146-151) subclasses, ``ReinhardNormalizer`` (:154-206) and
``get_normalizer`` (:209-237). ``fit``, ``transform`` and
``prepare_tile_transform`` are host float64 code, copied. ``transform_tiles``
applies the fitted transform to a uint8 tile batch on the device through
the port's stain kernel (``tiatoolbox_tpu_torch.ops.stain``).

Reinhard works on the host, as JAX's does: ``lab_split`` and ``merge_back``
use the port's bit-exact copies of OpenCV's 8-bit ``COLOR_RGB2LAB`` and
``COLOR_LAB2RGB`` (``utils/misc.py``), and ``cv2.meanStdDev`` becomes the
float64 mean and population standard deviation of the float32 channel.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.ops.stain import stain_transform
from tiatoolbox_tpu_torch.tools.stainextract import (
    CustomExtractor,
    MacenkoExtractor,
    RuifrokExtractor,
    VahadaneExtractor,
)
from tiatoolbox_tpu_torch.utils.exceptions import MethodNotSupportedError
from tiatoolbox_tpu_torch.utils.misc import lab2rgb_u8, rgb2lab_u8
from tiatoolbox_tpu_torch.utils.transforms import od2rgb, rgb2od


def load_stain_matrix(stain_matrix_input) -> np.ndarray:
    """A stain matrix from an ndarray, or from a ``.csv`` or ``.npy`` file."""
    if isinstance(stain_matrix_input, np.ndarray):
        return stain_matrix_input
    path = Path(stain_matrix_input)
    if path.suffix == ".csv":
        return np.loadtxt(path, delimiter=",", ndmin=2)
    if path.suffix == ".npy":
        return np.load(str(path))
    msg = "If supplying a path to a stain matrix, use either a npy or a csv file"
    raise ValueError(msg)


class StainNormalizer:
    """Map source stain appearance onto a fitted target image.

    Attributes:
        extractor: Stain-matrix extractor instance.
        stain_matrix_target: Target stain matrix (2x3).
        target_concentrations: Target concentration matrix.
        maxC_target: 99th percentile of target concentrations (1x2).
        stain_matrix_target_RGB: Target stains as RGB (visualisation).
    """

    def __init__(self) -> None:
        self.extractor = None
        self.stain_matrix_target: np.ndarray | None = None
        self.target_concentrations: np.ndarray | None = None
        self.maxC_target: np.ndarray | None = None
        self.stain_matrix_target_RGB: np.ndarray | None = None

    @staticmethod
    def get_concentrations(img: np.ndarray, stain_matrix: np.ndarray) -> np.ndarray:
        """Least-squares concentrations of each stain per pixel."""
        od = rgb2od(img).reshape((-1, 3))
        x, _, _, _ = np.linalg.lstsq(stain_matrix.T, od.T, rcond=-1)
        return x.T

    def fit(self, target: np.ndarray) -> None:
        """Fit to a target/reference uint8 RGB image."""
        self.stain_matrix_target = self.extractor.get_stain_matrix(target)
        self.target_concentrations = self.get_concentrations(
            target, self.stain_matrix_target
        )
        self.maxC_target = np.percentile(
            self.target_concentrations, 99, axis=0
        ).reshape((1, 2))
        self.stain_matrix_target_RGB = od2rgb(self.stain_matrix_target)

    def transform(self, img: np.ndarray) -> np.ndarray:
        """Stain-normalise one uint8 RGB image on the host in float64."""
        stain_matrix_source = self.extractor.get_stain_matrix(img)
        source_concentrations = self.get_concentrations(img, stain_matrix_source)
        max_c_source = np.percentile(source_concentrations, 99, axis=0).reshape((1, 2))
        source_concentrations *= self.maxC_target / max_c_source
        trans = 255 * np.exp(-1 * np.dot(source_concentrations, self.stain_matrix_target))
        trans[trans > 255] = 255
        trans[trans < 0] = 0
        return trans.reshape(img.shape).astype(np.uint8)

    def prepare_tile_transform(self, sample_img: np.ndarray) -> dict:
        """Estimate the source stains once; return the kernel's constants.

        Args:
            sample_img: A representative source image (a slide thumbnail
                or the first tiles).

        Returns:
            dict with float32 ``conc_proj`` [3, 2], ``target_stains``
            [2, 3] and ``conc_scale`` [2].
        """
        stain_matrix_source = self.extractor.get_stain_matrix(sample_img)
        source_concentrations = self.get_concentrations(
            sample_img, stain_matrix_source
        )
        max_c_source = np.percentile(source_concentrations, 99, axis=0)
        conc_proj = np.linalg.pinv(stain_matrix_source.T).T
        conc_scale = (self.maxC_target.reshape(-1) / max_c_source).astype(np.float32)
        return {
            "conc_proj": conc_proj.astype(np.float32),
            "target_stains": self.stain_matrix_target.astype(np.float32),
            "conc_scale": conc_scale,
        }

    def transform_tiles(
        self, tiles, constants: dict | None = None, device=None
    ) -> torch.Tensor:
        """Apply the fitted transform to a uint8 tile batch on ``device``.

        Args:
            tiles: uint8 ``[N, H, W, 3]`` (or any ``[..., 3]``) array or tensor.
            constants: Output of :meth:`prepare_tile_transform`; when None,
                estimated from the batch itself.
            device: Where the transform runs; ``rcParam["device"]`` by default.

        Returns:
            uint8 tensor of the batch's shape on ``device``.
        """
        dev = resolve_device(device)
        if constants is None:
            sample = np.asarray(torch.as_tensor(tiles).cpu()).reshape(1, -1, 3)
            constants = self.prepare_tile_transform(sample)
        batch = torch.as_tensor(tiles).to(dev, non_blocking=True).contiguous()
        return stain_transform(
            batch,
            constants["conc_proj"],
            constants["target_stains"],
            constants["conc_scale"],
        )


class CustomNormalizer(StainNormalizer):
    """Normalizer with a user-supplied stain matrix."""

    def __init__(self, stain_matrix: np.ndarray) -> None:
        super().__init__()
        self.extractor = CustomExtractor(stain_matrix)


class RuifrokNormalizer(StainNormalizer):
    """Ruifrok & Johnston colour-deconvolution normalizer."""

    def __init__(self) -> None:
        super().__init__()
        self.extractor = RuifrokExtractor()


class MacenkoNormalizer(StainNormalizer):
    """Macenko OD-eigenbasis normalizer."""

    def __init__(self) -> None:
        super().__init__()
        self.extractor = MacenkoExtractor()


class VahadaneNormalizer(StainNormalizer):
    """Vahadane sparse-NMF normalizer."""

    def __init__(self) -> None:
        super().__init__()
        self.extractor = VahadaneExtractor()


class ReinhardNormalizer(StainNormalizer):
    """Reinhard LAB mean/std matching (JAX ``stainnorm.py:154-206``)."""

    def __init__(self) -> None:
        super().__init__()
        self.target_means: tuple | None = None
        self.target_stds: tuple | None = None

    def fit(self, target: np.ndarray) -> None:
        means, stds = self.get_mean_std(target)
        self.target_means = means
        self.target_stds = stds

    def transform(self, img: np.ndarray) -> np.ndarray:
        chan1, chan2, chan3 = self.lab_split(img)
        means, stds = self.get_mean_std(img)
        norm1 = ((chan1 - means[0]) * (self.target_stds[0] / stds[0])) + self.target_means[0]
        norm2 = ((chan2 - means[1]) * (self.target_stds[1] / stds[1])) + self.target_means[1]
        norm3 = ((chan3 - means[2]) * (self.target_stds[2] / stds[2])) + self.target_means[2]
        return self.merge_back(norm1, norm2, norm3)

    def transform_tiles(self, tiles, constants: dict | None = None, device=None) -> np.ndarray:  # noqa: ARG002
        """Per-tile Reinhard on the host (the LAB conversions are OpenCV-exact)."""
        return np.stack([self.transform(np.asarray(t)) for t in tiles])

    @staticmethod
    def lab_split(img: np.ndarray) -> tuple:
        lab = rgb2lab_u8(img.astype("uint8")).astype(np.float32)
        chan1, chan2, chan3 = (lab[..., k].copy() for k in range(3))
        chan1 /= 2.55
        chan2 -= 128.0
        chan3 -= 128.0
        return chan1, chan2, chan3

    @staticmethod
    def merge_back(chan1, chan2, chan3) -> np.ndarray:
        chan1 *= 2.55
        chan2 += 128.0
        chan3 += 128.0
        merged = np.stack([chan1, chan2, chan3], axis=-1)
        # float -> uint8 truncates toward zero, as numpy's astype does after the clip
        return lab2rgb_u8(np.clip(merged, 0, 255).astype(np.uint8))

    def get_mean_std(self, img: np.ndarray) -> tuple:
        chan1, chan2, chan3 = self.lab_split(img.astype("uint8"))
        stats = [_mean_std_sequential(c) for c in (chan1, chan2, chan3)]
        means = tuple(m for m, _ in stats)
        stds = tuple(sd for _, sd in stats)
        return means, stds


def _mean_std_sequential(chan: np.ndarray) -> tuple[float, float]:
    """``cv2.meanStdDev`` of one float32 channel (JAX ``stainnorm.py:198-206``).

    cv2 sums ``v`` and ``v * v`` in float64 in pixel order and takes
    ``sqrt(max(q / n - mean**2, 0))``. ``np.cumsum`` keeps that order, where
    ``np.std``'s pairwise sums do not: on a flat channel whose value is not
    exact in binary (L = 53.72549 for grey 128) cv2 leaves a residual of
    1.33e-5 that a pairwise sum cancels to 0, and Reinhard's output then
    differs by up to 2 levels.
    """
    values = np.asarray(chan, np.float64).ravel()
    n = values.size
    mean = float(np.cumsum(values)[-1]) / n
    sq = float(np.cumsum(values * values)[-1]) / n
    return mean, float(np.sqrt(max(sq - mean * mean, 0.0)))


def get_normalizer(
    method_name: str, stain_matrix: np.ndarray | None = None
) -> StainNormalizer:
    """Stain normalizer by name: "reinhard", "custom", "ruifrok", "macenko"
    or "vahadane".

    Args:
        method_name: Normalizer name.
        stain_matrix: Only for "custom"; ndarray or path to .csv/.npy.

    Raises:
        MethodNotSupportedError: an unknown name, as JAX's raises.
        ValueError: ``stain_matrix`` given for another name than "custom",
            or missing for "custom".
    """
    name = method_name.lower()
    if name not in ("reinhard", "ruifrok", "macenko", "vahadane", "custom"):
        raise MethodNotSupportedError
    if stain_matrix is not None and name != "custom":
        msg = '`stain_matrix` is only defined when using `method_name`="custom".'
        raise ValueError(msg)
    if name == "reinhard":
        return ReinhardNormalizer()
    if name == "ruifrok":
        return RuifrokNormalizer()
    if name == "macenko":
        return MacenkoNormalizer()
    if name == "vahadane":
        return VahadaneNormalizer()
    if stain_matrix is None:
        msg = '`stain_matrix` is None when using `method_name`="custom".'
        raise ValueError(msg)
    return CustomNormalizer(load_stain_matrix(stain_matrix))
