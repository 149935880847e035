"""CNN backbones beyond the ResNets, with torchvision's parameter names.

Counterpart of ``tiatoolbox_tpu/models/architecture/cnn_backbones.py``
(:30-367): ``AlexNetFeatures`` (:30), ``DenseNetFeatures`` (121, 161, 169
and 201; :63), ``MobileNetV2Features`` (:118), ``MobileNetV3Features``
(large and small; :211), ``GoogLeNetFeatures`` (:249) and
``InceptionV3Features`` (:272), and ``EXTRA_BACKBONES`` (:354) with each
backbone's feature width. Each forward takes and returns NHWC, as the flax
modules do (the convolutions run in channels_last memory inside). The
modules carry torchvision's names (``features.N``,
``features.denseblockK.denselayerJ.conv1``, ``inception3a.branch2.1.conv``,
``Mixed_5b.branch1x1.conv``), so a torchvision-named ``state_dict`` loads by
name.

The topology is the JAX package's, where it differs from torchvision's:

- ``"SAME"`` padding is XLA's: ``same_pads`` computes it per input size, so
  a stride-2 layer on an even input pads one less before than after
  (MobileNet stems and strided depthwise convs, GoogLeNet's 7x7/2 stem and
  its max-pools, where torchvision uses ``ceil_mode``). Convs pad with
  zeros, max-pools with -inf, and the stride-1 average pools count the pads.
- Every batch norm has eps 1e-5 (``resnet.py:21``); torchvision uses 1e-3
  for MobileNetV3, GoogLeNet and InceptionV3.
- MobileNetV2 uses ReLU, not ReLU6; MobileNetV3's squeeze width is
  ``max(hidden // 4, 8)`` (:170).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.resnet import init_resnet_weights


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads_2d(x: torch.Tensor, kernel, stride) -> tuple[tuple[int, int], tuple[int, int]]:
    return (
        same_pads(x.shape[-2], kernel[0], stride[0]),
        same_pads(x.shape[-1], kernel[1], stride[1]),
    )


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with XLA's ``"SAME"`` padding for the input at hand.

    A symmetric padding goes to the convolution itself; an uneven one (a
    stride-2 layer on an even input) is applied with ``F.pad`` first.
    """

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, padding=0, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = _pads_2d(x, self.kernel_size, self.stride)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left), 1, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


class SameMaxPool2d(nn.Module):
    """Max-pool with XLA's ``"SAME"`` padding (-inf pads)."""

    def __init__(self, kernel: int, stride: int) -> None:
        super().__init__()
        self.kernel = kernel
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = _pads_2d(x, (self.kernel,) * 2, (self.stride,) * 2)
        if top == bottom and left == right:
            return F.max_pool2d(x, self.kernel, self.stride, (top, left))
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        return F.max_pool2d(x, self.kernel, self.stride)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 ``"SAME"`` average pool counting the pads (flax ``avg_pool``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5)


class BasicConv2d(nn.Module):
    """Conv (no bias, ``"SAME"``), batch norm, ReLU: torchvision's
    ``BasicConv2d`` (``_conv_bn_relu`` :17-27), or ``"VALID"`` with ``valid``."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1, *, valid: bool = False) -> None:
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        if valid:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, bias=False)
        else:
            self.conv = SameConv2d(in_ch, out_ch, kernel, stride, bias=False)
        self.bn = _bn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _NHWC(nn.Module):
    """A trunk whose ``trunk`` maps NCHW to NCHW, run NHWC to NHWC."""

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input -> NHWC feature map."""
        return self.trunk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class AlexNetFeatures(_NHWC):
    """AlexNet's ``features`` (:30-45): five convs with bias, VALID max-pools."""

    def __init__(self) -> None:
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
        )

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


class _DenseLayer(nn.Module):
    """BN-ReLU-1x1 conv, BN-ReLU-3x3 conv, concatenated after the input (:48-60)."""

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int = 4) -> None:
        super().__init__()
        self.norm1 = _bn(in_ch)
        self.conv1 = nn.Conv2d(in_ch, bn_size * growth_rate, 1, bias=False)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        h = self.conv2(F.relu(self.norm2(h)))
        return torch.cat([x, h], dim=1)


class _Transition(nn.Module):
    """BN-ReLU-1x1 conv, 2x2 average pool."""

    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.norm = _bn(in_ch)
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNetFeatures(_NHWC):
    """DenseNet trunk (:63-91): 121/161/169/201 by ``block_config``; the
    final batch norm ``norm5`` is followed by a ReLU."""

    def __init__(
        self, block_config: tuple = (6, 12, 24, 16), growth_rate: int = 32, init_features: int = 64
    ) -> None:
        super().__init__()
        layers: OrderedDict[str, nn.Module] = OrderedDict(
            conv0=nn.Conv2d(3, init_features, 7, 2, 3, bias=False),
            norm0=_bn(init_features),
            relu0=nn.ReLU(inplace=True),
            pool0=nn.MaxPool2d(3, 2, 1),
        )
        features = init_features
        for block_idx, n_layers in enumerate(block_config):
            block = nn.Sequential()
            for layer_idx in range(n_layers):
                block.add_module(f"denselayer{layer_idx + 1}", _DenseLayer(features, growth_rate))
                features += growth_rate
            layers[f"denseblock{block_idx + 1}"] = block
            if block_idx != len(block_config) - 1:
                layers[f"transition{block_idx + 1}"] = _Transition(features, features // 2)
                features //= 2
        layers["norm5"] = _bn(features)
        self.features = nn.Sequential(layers)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.features(x))


def _conv_bn_act(in_ch: int, out_ch: int, kernel: int, stride: int = 1, groups: int = 1, act=None) -> nn.Sequential:
    """torchvision's ``Conv2dNormActivation``: ``"SAME"`` conv (no bias), BN, act."""
    mods = [SameConv2d(in_ch, out_ch, kernel, stride, groups=groups, bias=False), _bn(out_ch)]
    if act is not None:
        mods.append(act)
    return nn.Sequential(*mods)


class _InvertedResidual(nn.Module):
    """MobileNetV2 block (:94-115): [1x1 expand], depthwise 3x3, 1x1 project."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int) -> None:
        super().__init__()
        hidden = in_ch * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn_act(in_ch, hidden, 1, act=nn.ReLU(inplace=True)))
        layers += [
            _conv_bn_act(hidden, hidden, 3, stride, groups=hidden, act=nn.ReLU(inplace=True)),
            nn.Conv2d(hidden, out_ch, 1, bias=False),
            _bn(out_ch),
        ]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x) if self.use_res else self.conv(x)


_MBV2 = (  # t, c, n, s
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class MobileNetV2Features(_NHWC):
    """MobileNetV2 trunk (:118-139): stem, 17 inverted residuals, 1x1 head to 1280."""

    def __init__(self) -> None:
        super().__init__()
        layers = [_conv_bn_act(3, 32, 3, 2, act=nn.ReLU(inplace=True))]
        in_ch = 32
        for t, c, n, s in _MBV2:
            for i in range(n):
                layers.append(_InvertedResidual(in_ch, c, s if i == 0 else 1, t))
                in_ch = c
        layers.append(_conv_bn_act(in_ch, 1280, 1, act=nn.ReLU(inplace=True)))
        self.features = nn.Sequential(*layers)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


class _SqueezeExcitation(nn.Module):
    """Mean, 1x1 conv, ReLU, 1x1 conv, hard sigmoid, scale (:168-173)."""

    def __init__(self, channels: int, squeeze: int) -> None:
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.mean(dim=(2, 3), keepdim=True)
        return x * F.hardsigmoid(self.fc2(F.relu(self.fc1(se))))


class _MBV3Block(nn.Module):
    """MobileNetV3 block (:142-178): [expand], depthwise k x k, [SE], project."""

    def __init__(self, in_ch: int, out_ch: int, hidden: int, kernel: int, stride: int, use_se: bool, use_hs: bool) -> None:
        super().__init__()
        act = nn.Hardswish if use_hs else nn.ReLU
        layers: list[nn.Module] = []
        if hidden != in_ch:
            layers.append(_conv_bn_act(in_ch, hidden, 1, act=act()))
        layers.append(_conv_bn_act(hidden, hidden, kernel, stride, groups=hidden, act=act()))
        if use_se:
            layers.append(_SqueezeExcitation(hidden, max(hidden // 4, 8)))
        layers.append(_conv_bn_act(hidden, out_ch, 1))
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x) if self.use_res else self.block(x)


_MBV3_LARGE = (  # k, hidden, out, se, hs, s
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)
_MBV3_SMALL = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)


class MobileNetV3Features(_NHWC):
    """MobileNetV3 trunk (:211-225), ``variant`` "large" or "small"."""

    def __init__(self, variant: str = "large") -> None:
        super().__init__()
        cfg = _MBV3_LARGE if variant == "large" else _MBV3_SMALL
        layers = [_conv_bn_act(3, 16, 3, 2, act=nn.Hardswish())]
        in_ch = 16
        for k, hidden, out, se, hs, s in cfg:
            layers.append(_MBV3Block(in_ch, out, hidden, k, s, se, hs))
            in_ch = out
        head = 960 if variant == "large" else 576
        layers.append(_conv_bn_act(in_ch, head, 1, act=nn.Hardswish()))
        self.features = nn.Sequential(*layers)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)


class _Inception(nn.Module):
    """GoogLeNet inception block (:228-246); branch 3's conv is 3x3, as in
    torchvision."""

    def __init__(self, in_ch: int, b1: int, b2: tuple, b3: tuple, b4: int) -> None:
        super().__init__()
        self.branch1 = BasicConv2d(in_ch, b1, 1)
        self.branch2 = nn.Sequential(BasicConv2d(in_ch, b2[0], 1), BasicConv2d(b2[0], b2[1], 3))
        self.branch3 = nn.Sequential(BasicConv2d(in_ch, b3[0], 1), BasicConv2d(b3[0], b3[1], 3))
        self.branch4 = nn.Sequential(SameMaxPool2d(3, 1), BasicConv2d(in_ch, b4, 1))
        self.out_ch = b1 + b2[1] + b3[1] + b4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)], dim=1)


_GOOGLENET = (  # name, b1, b2, b3, b4, then a max-pool
    ("inception3a", 64, (96, 128), (16, 32), 32, None),
    ("inception3b", 128, (128, 192), (32, 96), 64, "maxpool3"),
    ("inception4a", 192, (96, 208), (16, 48), 64, None),
    ("inception4b", 160, (112, 224), (24, 64), 64, None),
    ("inception4c", 128, (128, 256), (24, 64), 64, None),
    ("inception4d", 112, (144, 288), (32, 64), 64, None),
    ("inception4e", 256, (160, 320), (32, 128), 128, "maxpool4"),
    ("inception5a", 256, (160, 320), (32, 128), 128, None),
    ("inception5b", 384, (192, 384), (48, 128), 128, None),
)


class GoogLeNetFeatures(_NHWC):
    """GoogLeNet (Inception v1) trunk (:249-269)."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1 = BasicConv2d(3, 64, 7, 2)
        self.maxpool1 = SameMaxPool2d(3, 2)
        self.conv2 = BasicConv2d(64, 64, 1)
        self.conv3 = BasicConv2d(64, 192, 3)
        self.maxpool2 = SameMaxPool2d(3, 2)
        in_ch = 192
        self._order = ["conv1", "maxpool1", "conv2", "conv3", "maxpool2"]
        for name, b1, b2, b3, b4, pool in _GOOGLENET:
            block = _Inception(in_ch, b1, b2, b3, b4)
            self.add_module(name, block)
            self._order.append(name)
            in_ch = block.out_ch
            if pool is not None:
                self.add_module(pool, SameMaxPool2d(3 if pool == "maxpool3" else 2, 2))
                self._order.append(pool)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._order:
            x = getattr(self, name)(x)
        return x


class _InceptionA(nn.Module):
    """1x1; 1x1-5x5; 1x1-3x3-3x3; avg-pool-1x1 (:283-293)."""

    def __init__(self, in_ch: int, pool_ch: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3)
        self.branch_pool = BasicConv2d(in_ch, pool_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class _InceptionB(nn.Module):
    """Reduction A (:299-305): 3x3/2; 1x1-3x3-3x3/2; max-pool."""

    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, 2, valid=True)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 2, valid=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b3, F.max_pool2d(x, 3, 2)], dim=1)


class _InceptionC(nn.Module):
    """1x1; 1x7-7x1 pair; 7x1-1x7 twice; avg-pool-1x1 (:307-320)."""

    def __init__(self, in_ch: int, ch7: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, ch7, 1)
        self.branch7x7_2 = BasicConv2d(ch7, ch7, (1, 7))
        self.branch7x7_3 = BasicConv2d(ch7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, ch7, 1)
        self.branch7x7dbl_2 = BasicConv2d(ch7, ch7, (7, 1))
        self.branch7x7dbl_3 = BasicConv2d(ch7, ch7, (1, 7))
        self.branch7x7dbl_4 = BasicConv2d(ch7, ch7, (7, 1))
        self.branch7x7dbl_5 = BasicConv2d(ch7, 192, (1, 7))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class _InceptionD(nn.Module):
    """Reduction B (:327-335): 1x1-3x3/2; 1x1-1x7-7x1-3x3/2; max-pool."""

    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 2, valid=True)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 2, valid=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class _InceptionE(nn.Module):
    """1x1; 1x1 then 1x3 and 3x1; 1x1-3x3 then 1x3 and 3x1; avg-pool-1x1 (:337-348)."""

    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat(
            [
                self.branch1x1(x),
                self.branch3x3_2a(b3),
                self.branch3x3_2b(b3),
                self.branch3x3dbl_3a(bd),
                self.branch3x3dbl_3b(bd),
                self.branch_pool(_avg_pool_same(x)),
            ],
            dim=1,
        )


class InceptionV3Features(_NHWC):
    """InceptionV3 trunk (:272-351), Mixed_5b to Mixed_7c; the stem's strided
    and 3x3 convs are ``"VALID"`` apart from ``Conv2d_2b_3x3``."""

    def __init__(self) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2, valid=True)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, valid=True)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, valid=True)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, valid=True)
        self.Mixed_5b = _InceptionA(192, 32)
        self.Mixed_5c = _InceptionA(256, 64)
        self.Mixed_5d = _InceptionA(288, 64)
        self.Mixed_6a = _InceptionB(288)
        self.Mixed_6b = _InceptionC(768, 128)
        self.Mixed_6c = _InceptionC(768, 160)
        self.Mixed_6d = _InceptionC(768, 160)
        self.Mixed_6e = _InceptionC(768, 192)
        self.Mixed_7a = _InceptionD(768)
        self.Mixed_7b = _InceptionE(1280)
        self.Mixed_7c = _InceptionE(2048)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x


EXTRA_BACKBONES = {
    "alexnet": (AlexNetFeatures, {}, 256),
    "densenet121": (DenseNetFeatures, {"block_config": (6, 12, 24, 16)}, 1024),
    "densenet161": (
        DenseNetFeatures,
        {"block_config": (6, 12, 36, 24), "growth_rate": 48, "init_features": 96},
        2208,
    ),
    "densenet169": (DenseNetFeatures, {"block_config": (6, 12, 32, 32)}, 1664),
    "densenet201": (DenseNetFeatures, {"block_config": (6, 12, 48, 32)}, 1920),
    "mobilenet_v2": (MobileNetV2Features, {}, 1280),
    "mobilenet_v3_large": (MobileNetV3Features, {"variant": "large"}, 960),
    "mobilenet_v3_small": (MobileNetV3Features, {"variant": "small"}, 576),
    "googlenet": (GoogLeNetFeatures, {}, 1024),
    "inception_v3": (InceptionV3Features, {}, 2048),
}


def init_backbone_weights(module: nn.Module, generator: torch.Generator) -> None:
    """``init_resnet_weights`` (Kaiming convs, identity batch norms, uniform
    linears, all from ``generator``), and zero conv biases."""
    init_resnet_weights(module, generator)
    for m in module.modules():
        if isinstance(m, nn.Conv2d) and m.bias is not None:
            nn.init.zeros_(m.bias)
