"""CNN patch classifier (counterpart of ``tiatoolbox_tpu/models/architecture/vanilla.py``).

``CNNModel`` (:87): a named ResNet backbone (``feat_extract``), global
average pooling and a linear head (``classifier``): the parameter names of
the reference tiatoolbox ``CNNModel``, so its ``.pth`` checkpoints load as
they are. ``forward`` returns logits; ``infer_batch_device`` adds the
softmax in float32, as the flax module's ``__call__`` does. The model is
built on ``resolve_device(device)``: CUDA unless ``device="cpu"`` is asked
for, and an error where CUDA is asked for and absent. A reduced-precision
``compute_dtype`` casts the weights too (``ModelABC.place``).
"""

from __future__ import annotations

import torch
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.resnet import (
    RESNET_CONFIGS,
    RESNET_FEATURES,
    ResNet,
    init_resnet_weights,
)
from tiatoolbox_tpu_torch.models.models_abc import ModelABC


class CNNModel(ModelABC):
    """Patch classifier: ResNet backbone + linear head, softmax output.

    Args:
        backbone: Backbone name (e.g. "resnet18").
        num_classes: Number of output classes.
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator`` the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        backbone: str,
        num_classes: int = 1,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        if backbone not in RESNET_CONFIGS:
            msg = f"Backbone {backbone!r} not supported."
            raise ValueError(msg)
        super().__init__(compute_dtype)
        self.backbone = backbone
        self.num_classes = num_classes
        self.feat_extract = ResNet(**RESNET_CONFIGS[backbone])
        self.classifier = nn.Linear(RESNET_FEATURES[backbone], num_classes)
        init_resnet_weights(self, torch.Generator().manual_seed(seed))
        self.place(device)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch -> logits ``[N, num_classes]``."""
        feat = self.feat_extract(batch)
        return self.classifier(feat.mean(dim=(1, 2)))

    @classmethod
    def infer_batch_device(cls, model: "CNNModel", batch_data, device=None):
        """uint8 NHWC batch -> float32 softmax probabilities on the device."""
        logits = super().infer_batch_device(model, batch_data, device)
        return torch.softmax(logits.float(), dim=-1)
