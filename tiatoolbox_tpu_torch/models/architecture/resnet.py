"""ResNet family with torchvision's topology and parameter names.

Counterpart of ``tiatoolbox_tpu/models/architecture/resnet.py``:
``BasicBlock`` (:60), ``Bottleneck`` (:81) and ``ResNet`` (:149) with the
7x7/s2 conv stem. ``ResNet.forward`` takes and returns NHWC, as the flax
module does; inside, the convolutions run in channels_last memory format
(an NHWC tensor permuted to NCHW is already channels_last). Batch norm
uses its running statistics (the model runs in eval mode).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def conv3x3(in_planes: int, out_planes: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    """3x3 conv, pad 1, no bias (torchvision ``conv3x3``)."""
    return nn.Conv2d(
        in_planes, out_planes, 3, stride=stride, padding=1, groups=groups, bias=False
    )


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    """1x1 conv, no bias (torchvision ``conv1x1``)."""
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3(stride) -> 3x3, residual add."""

    expansion = 1

    def __init__(
        self,
        in_planes: int,
        planes: int,
        stride: int = 1,
        downsample: nn.Module | None = None,
        groups: int = 1,  # noqa: ARG002 - shared block signature
        width: int | None = None,  # noqa: ARG002 - shared block signature
    ) -> None:
        super().__init__()
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5: stride on the 3x3 conv)."""

    expansion = 4

    def __init__(
        self,
        in_planes: int,
        planes: int,
        stride: int = 1,
        downsample: nn.Module | None = None,
        groups: int = 1,
        width: int | None = None,
    ) -> None:
        super().__init__()
        width = planes if width is None else width
        self.conv1 = conv1x1(in_planes, width)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = conv3x3(width, width, stride, groups)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = conv1x1(width, planes * self.expansion)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-style ResNet feature extractor (no pooling, no head).

    Args:
        layers: Blocks per stage, e.g. (2, 2, 2, 2) for resnet18.
        block: "basic" or "bottleneck".
        groups / width_per_group: ResNeXt / wide-ResNet widths.
    """

    def __init__(
        self,
        layers: Sequence[int] = (2, 2, 2, 2),
        block: str = "basic",
        groups: int = 1,
        width_per_group: int = 64,
    ) -> None:
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        in_planes = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * (2**stage)
            width = int(planes * (width_per_group / 64.0)) * groups
            out_planes = planes * block_cls.expansion
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                downsample = None
                if b == 0 and (stride != 1 or in_planes != out_planes):
                    downsample = nn.Sequential(
                        conv1x1(in_planes, out_planes, stride),
                        nn.BatchNorm2d(out_planes),
                    )
                blocks.append(
                    block_cls(in_planes, planes, stride, downsample, groups, width)
                )
                in_planes = out_planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input -> NHWC feature map."""
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.permute(0, 2, 3, 1)


RESNET_CONFIGS = {
    "resnet18": dict(layers=(2, 2, 2, 2), block="basic"),
    "resnet34": dict(layers=(3, 4, 6, 3), block="basic"),
    "resnet50": dict(layers=(3, 4, 6, 3), block="bottleneck"),
    "resnet101": dict(layers=(3, 4, 23, 3), block="bottleneck"),
    "resnet152": dict(layers=(3, 8, 36, 3), block="bottleneck"),
    "resnext50_32x4d": dict(
        layers=(3, 4, 6, 3), block="bottleneck", groups=32, width_per_group=4
    ),
    "resnext101_32x8d": dict(
        layers=(3, 4, 23, 3), block="bottleneck", groups=32, width_per_group=8
    ),
    "wide_resnet50_2": dict(layers=(3, 4, 6, 3), block="bottleneck", width_per_group=128),
    "wide_resnet101_2": dict(
        layers=(3, 4, 23, 3), block="bottleneck", width_per_group=128
    ),
}

RESNET_FEATURES = {name: 512 if cfg["block"] == "basic" else 2048 for name, cfg in RESNET_CONFIGS.items()}


def init_resnet_weights(module: nn.Module, generator: torch.Generator) -> None:
    """torchvision's ResNet initialisation, drawn from ``generator``.

    Convs: Kaiming normal (fan_out, relu); batch norm: weight 1, bias 0,
    running mean 0, running var 1; linear: PyTorch's default uniform.
    """
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(
                m.weight, mode="fan_out", nonlinearity="relu", generator=generator
            )
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.reset_running_stats()
        elif isinstance(m, nn.Linear):
            bound = 1.0 / m.in_features**0.5
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
