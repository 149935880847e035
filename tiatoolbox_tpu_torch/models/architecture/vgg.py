"""VGG16's convolutional trunk for DFBR registration (counterpart of
``tiatoolbox_tpu/models/architecture/vgg.py``).

``VGG16Features`` is JAX's module (:25-49) under torchvision's
``vgg16().features`` names (``features.0``, ``features.2``, ...,
``features.28``), so a torchvision ``vgg16`` checkpoint loads by name: the
configuration "D" trunk, ImageNet normalisation inside, and the outputs of
the block 3, 4 and 5 max pools (torchvision's layers 16, 23 and 30).
``seeded_vgg16_state`` draws torchvision's initialisation (He normal,
fan-out, zero biases) from a seeded ``torch.Generator`` for runs without a
checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

# torchvision vgg16 "D" configuration: conv channel per block
VGG16_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
# sequential indices of the conv layers in torchvision vgg16.features
VGG16_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# indices of the block 3, 4 and 5 max pools, whose outputs are returned
VGG16_OUTPUT_IDS = (16, 23, 30)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    """VGG16 trunk: NCHW float in [0, 1] -> the block 3, 4 and 5 pool outputs."""

    def __init__(self) -> None:
        super().__init__()
        layers: list[nn.Module] = []
        channels = 3
        for widths in VGG16_BLOCKS:
            for width in widths:
                layers += [nn.Conv2d(channels, width, 3, padding=1), nn.ReLU(inplace=True)]
                channels = width
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Normalise to ImageNet's mean and std, then run the trunk."""
        x = (x - self.mean) / self.std
        outputs = []
        for index, layer in enumerate(self.features):
            x = layer(x)
            if index in VGG16_OUTPUT_IDS:
                outputs.append(x)
        return outputs


def seeded_vgg16_state(seed: int = 0) -> dict[str, torch.Tensor]:
    """A ``VGG16Features`` state dict with torchvision's initialisation
    (``kaiming_normal_(mode="fan_out", nonlinearity="relu")``, zero biases),
    drawn on the CPU from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    channels = 3
    conv = iter(VGG16_CONV_IDS)
    for widths in VGG16_BLOCKS:
        for width in widths:
            index = next(conv)
            std = (2.0 / (width * 9)) ** 0.5
            state[f"features.{index}.weight"] = torch.randn(width, channels, 3, 3, generator=gen) * std
            state[f"features.{index}.bias"] = torch.zeros(width)
            channels = width
    return state
