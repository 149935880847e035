"""Models, datasets and engines of the port."""

from tiatoolbox_tpu_torch.models.models_abc import ModelABC  # noqa: F401
