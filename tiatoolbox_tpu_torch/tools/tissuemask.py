"""Tissue masking (counterpart of ``tiatoolbox_tpu/tools/tissuemask.py``).

``otsu_threshold`` (:19) and ``OtsuTissueMasker`` (:76) are copied, with the
greyscale conversion done by ``rgb2gray_u8`` (bit-exact to OpenCV's).
``MorphologicalMasker`` (:103) uses ``scipy.ndimage`` for the 8-connected
small-region removal and the dilation, with OpenCV's elliptical
structuring element and anchor, so its masks equal the OpenCV ones.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
from scipy import ndimage

from tiatoolbox_tpu_torch.utils.misc import objective_power2mpp, rgb2gray_u8


def ellipse_kernel(ksize: tuple[int, int]) -> np.ndarray:
    """uint8 elliptical structuring element of (width, height) ``ksize``.

    OpenCV's ``getStructuringElement(MORPH_ELLIPSE, ksize)`` row by row.
    """
    width, height = int(ksize[0]), int(ksize[1])
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    kernel = np.zeros((height, width), np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            kernel[i, max(c - dx, 0) : min(c + dx + 1, width)] = 1
    return kernel


def _dilate(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """OpenCV-style binary dilation: anchor at the kernel centre, zero border.

    ``dst[p] = any(src[p + k - anchor] for k in kernel)``; scipy places the
    structure's centre at ``size // 2``, the same anchor, and reflects it.
    """
    structure = kernel[::-1, ::-1].astype(bool)
    origin = [-(1 - s % 2) for s in structure.shape]
    return ndimage.binary_dilation(mask, structure=structure, origin=origin)


def otsu_threshold(values: np.ndarray, nbins: int = 256) -> float:
    """Otsu's threshold of a sample of greyscale values.

    Histogram-based inter-class variance maximisation; returns the bin
    center, matching ``skimage.filters.threshold_otsu`` behaviour.
    """
    values = np.asarray(values).ravel()
    if values.size == 0:
        msg = "Cannot threshold an empty array."
        raise ValueError(msg)
    if np.issubdtype(values.dtype, np.integer) and values.max() <= 255 and values.min() >= 0:
        hist = np.bincount(values.astype(np.uint8), minlength=256).astype(float)
        bin_centers = np.arange(256, dtype=float)
    else:
        hist, bin_edges = np.histogram(values, bins=nbins)
        hist = hist.astype(float)
        bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    # cumulative class probabilities and means
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    mean1 = np.cumsum(hist * bin_centers) / np.maximum(weight1, 1e-12)
    mean2 = (np.cumsum((hist * bin_centers)[::-1]) / np.maximum(weight2[::-1], 1e-12))[
        ::-1
    ]
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    idx = int(np.argmax(variance12))
    return float(bin_centers[idx])


class TissueMasker(ABC):
    """Base class: fit on thumbnails, transform to boolean masks."""

    def __init__(self) -> None:
        self.fitted = False

    @abstractmethod
    def fit(self, images: np.ndarray, masks: np.ndarray | None = None) -> None:
        """Fit the masker to images (NHWC)."""

    @abstractmethod
    def transform(self, images: np.ndarray) -> np.ndarray:
        """Produce boolean masks (NHW) for images (NHWC)."""

    def fit_transform(self, images: np.ndarray, **kwargs) -> np.ndarray:
        """fit then transform."""
        self.fit(images, masks=None, **kwargs)
        return self.transform(images)


def _to_grey(image: np.ndarray) -> np.ndarray:
    if image.ndim == 3 and image.shape[-1] == 3:
        return rgb2gray_u8(image)
    if image.ndim == 3:
        return image[..., 0]
    return image


class OtsuTissueMasker(TissueMasker):
    """Greyscale Otsu threshold masker (tissue = darker than threshold)."""

    def __init__(self) -> None:
        super().__init__()
        self.threshold: float | None = None

    def fit(self, images: np.ndarray, masks: np.ndarray | None = None) -> None:  # noqa: ARG002
        images_shape = np.shape(images)
        if len(images_shape) != 4:
            msg = (
                f"Expected 4 dimensional input shape (N, height, width, 3) "
                f"but received shape of {images_shape}."
            )
            raise ValueError(msg)
        pixels = np.concatenate([_to_grey(np.asarray(img)).ravel() for img in images])
        self.threshold = otsu_threshold(pixels)
        self.fitted = True

    def transform(self, images: np.ndarray) -> np.ndarray:
        if not self.fitted:
            msg = "Fit must be called before transform."
            raise SyntaxError(msg)
        masks = [(_to_grey(np.asarray(img)) < self.threshold) for img in images]
        return np.array(masks)


class MorphologicalMasker(OtsuTissueMasker):
    """Otsu threshold + small-object removal + elliptical dilation.

    Kernel size is 32/mpp pixels (power converted to mpp first); the
    minimum region size defaults to the kernel area. Matches reference
    ``tissuemask.py:167-306``.
    """

    def __init__(
        self,
        *,
        mpp=None,
        power=None,
        kernel_size=None,
        min_region_size: int | None = None,
    ) -> None:
        super().__init__()
        self.min_region_size = min_region_size
        if sum(arg is not None for arg in (mpp, power, kernel_size)) > 1:
            msg = "Only one of mpp, power, kernel_size can be given."
            raise ValueError(msg)
        if all(arg is None for arg in (mpp, power, kernel_size)):
            kernel_size = np.array([1, 1])
        if power is not None:
            mpp = objective_power2mpp(power)
        if mpp is not None:
            mpp_array = np.array(mpp)
            if mpp_array.size != 2:
                mpp_array = mpp_array.repeat(2)
            kernel_size = np.max([32 / mpp_array, np.array([1, 1])], axis=0)
        kernel_size_array = np.array(kernel_size)
        if kernel_size_array.size != 2:
            kernel_size_array = kernel_size_array.repeat(2)
        self.kernel_size = tuple(np.round(kernel_size_array).astype(int))
        self.kernel = ellipse_kernel(self.kernel_size)
        if self.min_region_size is None:
            self.min_region_size = int(np.sum(self.kernel))

    def transform(self, images: np.ndarray) -> np.ndarray:
        if not self.fitted:
            msg = "Fit must be called before transform."
            raise SyntaxError(msg)
        results = []
        for image in images:
            gray = _to_grey(np.asarray(image))
            mask = gray < self.threshold
            labels, _ = ndimage.label(mask, structure=np.ones((3, 3), bool))
            sizes = np.bincount(labels.ravel())
            mask &= (sizes >= self.min_region_size)[labels]
            mask = _dilate(mask, self.kernel)
            results.append(mask.astype(bool))
        return np.array(results)
