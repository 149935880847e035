"""CNN patch classifiers and feature backbones (counterpart of ``tiatoolbox_tpu/models/architecture/vanilla.py``).

``backbone_dict``, ``get_backbone`` and ``_FEATURE_WIDTHS`` (:33-50) cover
the ResNets and ``cnn_backbones.EXTRA_BACKBONES``. ``CNNModel`` (:87) is a
named backbone (``feat_extract``), global average pooling and a linear
head (``classifier``): the parameter names of the reference tiatoolbox
``CNNModel``, torchvision's inside. ``forward`` returns logits;
``infer_batch_device`` adds the softmax in float32, as the flax module's
``__call__`` does (:58-71). ``CNNBackbone`` (:146-163) is the backbone and
the pooling: feature embeddings. The models are built on
``resolve_device(device)``: CUDA unless ``device="cpu"`` is asked for, and
an error where CUDA is asked for and absent. A reduced-precision
``compute_dtype`` casts the weights too (``ModelABC.place``). The
space-to-depth stem of the flax ResNets (:53-55, :104-126) is a TPU rewrite
and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import EXTRA_BACKBONES, init_backbone_weights
from tiatoolbox_tpu_torch.models.architecture.resnet import RESNET_CONFIGS, RESNET_FEATURES, ResNet
from tiatoolbox_tpu_torch.models.models_abc import ModelABC

backbone_dict = {name: (ResNet, cfg) for name, cfg in RESNET_CONFIGS.items()}
backbone_dict.update({name: (cls, cfg) for name, (cls, cfg, _) in EXTRA_BACKBONES.items()})
_FEATURE_WIDTHS = dict(RESNET_FEATURES)
_FEATURE_WIDTHS.update({name: width for name, (_, _, width) in EXTRA_BACKBONES.items()})


def get_backbone(backbone: str) -> tuple[nn.Module, int]:
    """A named backbone module (NHWC in, NHWC out) and its feature width."""
    if backbone not in backbone_dict:
        msg = f"Backbone {backbone!r} not supported."
        raise ValueError(msg)
    cls, cfg = backbone_dict[backbone]
    return cls(**cfg), _FEATURE_WIDTHS[backbone]


class CNNBackbone(ModelABC):
    """Feature extractor: named backbone + global average pooling.

    Args:
        backbone: Backbone name (e.g. "resnet50", "densenet121").
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator`` the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        backbone: str,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(compute_dtype)
        self.backbone = backbone
        self.feat_extract, self.num_features = get_backbone(backbone)
        self._build_head()
        init_backbone_weights(self, torch.Generator().manual_seed(seed))
        self.place(device)

    def _build_head(self) -> None:
        """Layers after the pooling (none for a feature extractor)."""

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch -> pooled features ``[N, num_features]``."""
        return self.feat_extract(batch).mean(dim=(1, 2))


class CNNModel(CNNBackbone):
    """Patch classifier: named backbone + linear head, softmax output.

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
        self.num_classes = num_classes
        super().__init__(backbone, compute_dtype, seed, device)

    def _build_head(self) -> None:
        self.classifier = nn.Linear(self.num_features, self.num_classes)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch -> logits ``[N, num_classes]``."""
        return self.classifier(super().forward(batch))

    @staticmethod
    def postproc(image: np.ndarray) -> np.ndarray:
        """argmax over class probabilities."""
        return np.argmax(image, axis=-1)

    @classmethod
    def infer_batch_device(cls, model: "CNNModel", batch_data, device=None):
        """uint8 NHWC batch -> float32 softmax probabilities on the device."""
        logits = super().infer_batch_device(model, batch_data, device)
        return torch.softmax(logits.float(), dim=-1)
