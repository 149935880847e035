"""IDaRS classifiers (counterpart of ``tiatoolbox_tpu/models/architecture/idars.py``).

A ``CNNModel`` whose one difference is the host preprocessing (:20-44):
``idars_preproc`` scales to [0, 1] and normalises with mean 0.5 and std 0.1
per channel, in float32 HWC. ``ModelABC.apply_u8`` takes the float batch as
model-ready and only casts it. The registry's ``dataset: idars`` entries
attach ``idars_preproc`` through ``predefined_preproc_func``.
"""

from __future__ import annotations

import numpy as np

from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel


def idars_preproc(image: np.ndarray) -> np.ndarray:
    """((x / 255) - 0.5) / 0.1, float32 HWC (JAX :20-28)."""
    image = np.asarray(image, np.float32) / 255.0
    return (image - 0.5) / 0.1


class IDaRS(CNNModel):
    """``CNNModel`` with the IDaRS preprocessing as its ``preproc``.

    Args:
        backbone: Backbone name (e.g. "resnet18").
        num_classes: Number of output classes.
        **kwargs: ``CNNModel``'s ``compute_dtype``, ``seed`` and ``device``.
    """

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """IDaRS per-patch normalisation (host side)."""
        return idars_preproc(image)
