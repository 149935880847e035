"""Patch datasets of the port."""

from tiatoolbox_tpu_torch.models.dataset.classification import predefined_preproc_func
from tiatoolbox_tpu_torch.models.dataset.dataset_abc import (
    PatchDataset,
    PatchDatasetABC,
    WSIPatchDataset,
)

__all__ = ["PatchDataset", "PatchDatasetABC", "WSIPatchDataset", "predefined_preproc_func"]
