"""EfficientNet (B0-B7) and EfficientNetV2 encoders with timm's parameter names.

Counterpart of ``tiatoolbox_tpu/models/architecture/efficientnet.py``
(:17-348): ``EFFICIENTNET_PARAMS`` (:17), ``MBConv`` (:77), the
``EfficientNetEncoder`` (:120) with its per-stage features at strides 2, 4,
8, 16 and 32, ``ConvBnAct`` (:165), ``FusedMBConv`` (:192),
``EFFICIENTNETV2_CONFIGS`` (:225), ``EfficientNetV2Encoder`` (:264),
``EfficientNetClassifier`` (:314) and ``EFFICIENTNET_STAGE_CHANNELS``
(:338). Forwards take NHWC and return NHWC, as the flax modules do.

Names are timm's: ``conv_stem``, ``bn1``, ``blocks.{stage}.{block}``, and
inside a block ``conv_pw``/``bn1``/``conv_dw``/``bn2``/``se.conv_reduce``/
``se.conv_expand``/``conv_pwl``/``bn3`` (an inverted residual),
``conv_dw``/``bn1``/``se``/``conv_pw``/``bn2`` (expansion 1),
``conv_exp``/``bn1``/``conv_pwl``/``bn2`` (fused) or ``conv``/``bn1``
(conv-BN-act); the classifier adds ``conv_head``, ``bn2`` and
``classifier``. As in the JAX module: the default ``"SAME"`` padding is
XLA's, per input size (``"symmetric"`` pads k // 2 on both sides), batch
norms have eps 1e-3, and the squeeze width is a quarter of the block's
input channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import SameConv2d

# (width_mult, depth_mult)
EFFICIENTNET_PARAMS = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6),
    "efficientnet_b7": (2.0, 3.1),
}

# (expand_ratio, channels, repeats, kernel, stride)
_B0_BLOCKS = (
    (1, 16, 1, 3, 1),
    (6, 24, 2, 3, 2),
    (6, 40, 2, 5, 2),
    (6, 80, 3, 3, 2),
    (6, 112, 3, 5, 1),
    (6, 192, 4, 5, 2),
    (6, 320, 1, 3, 1),
)


def _round_channels(channels: float, width_mult: float, divisor: int = 8) -> int:
    channels *= width_mult
    new = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new < 0.9 * channels:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: str = "SAME", groups: int = 1) -> nn.Conv2d:
    """A bias-free conv: ``"SAME"`` (XLA's) or ``"symmetric"`` (k // 2 both sides)."""
    if padding == "symmetric":
        return nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, groups=groups, bias=False)
    return SameConv2d(in_ch, out_ch, kernel, stride, groups=groups, bias=False)


class _SqueezeExcite(nn.Module):
    """Mean, 1x1 conv, SiLU, 1x1 conv, sigmoid, scale."""

    def __init__(self, channels: int, squeeze: int) -> None:
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, squeeze, 1)
        self.conv_expand = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(se))


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite (:77-117)."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        expand_ratio: int,
        kernel: int,
        stride: int,
        conv_padding: str = "SAME",
        bn_eps: float = 1e-3,
    ) -> None:
        super().__init__()
        expanded = in_ch * expand_ratio
        self.expand = expand_ratio != 1
        dw = _conv(expanded, expanded, kernel, stride, conv_padding, groups=expanded)
        se = _SqueezeExcite(expanded, max(1, in_ch // 4))
        project = nn.Conv2d(expanded, out_ch, 1, bias=False)
        if self.expand:
            self.conv_pw = nn.Conv2d(in_ch, expanded, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(expanded, eps=bn_eps)
            self.conv_dw, self.bn2, self.se = dw, nn.BatchNorm2d(expanded, eps=bn_eps), se
            self.conv_pwl, self.bn3 = project, nn.BatchNorm2d(out_ch, eps=bn_eps)
        else:
            self.conv_dw, self.bn1, self.se = dw, nn.BatchNorm2d(expanded, eps=bn_eps), se
            self.conv_pw, self.bn2 = project, nn.BatchNorm2d(out_ch, eps=bn_eps)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand:
            h = F.silu(self.bn1(self.conv_pw(x)))
            h = self.se(F.silu(self.bn2(self.conv_dw(h))))
            h = self.bn3(self.conv_pwl(h))
        else:
            h = self.se(F.silu(self.bn1(self.conv_dw(x))))
            h = self.bn2(self.conv_pw(h))
        return h + x if self.use_res else h


class ConvBnAct(nn.Module):
    """timm's "cn" block: conv, BN, SiLU, residual after the activation (:165-189)."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel: int, stride: int, conv_padding: str = "SAME", bn_eps: float = 1e-3
    ) -> None:
        super().__init__()
        self.conv = _conv(in_ch, out_ch, kernel, stride, conv_padding)
        self.bn1 = nn.BatchNorm2d(out_ch, eps=bn_eps)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.bn1(self.conv(x)))
        return h + x if self.use_res else h


class FusedMBConv(nn.Module):
    """timm's EdgeResidual ("er"): fused k x k expand, 1x1 project, no SE (:192-222)."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        expand_ratio: int,
        kernel: int,
        stride: int,
        conv_padding: str = "SAME",
        bn_eps: float = 1e-3,
    ) -> None:
        super().__init__()
        expanded = in_ch * expand_ratio
        self.conv_exp = _conv(in_ch, expanded, kernel, stride, conv_padding)
        self.bn1 = nn.BatchNorm2d(expanded, eps=bn_eps)
        self.conv_pwl = nn.Conv2d(expanded, out_ch, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=bn_eps)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return h + x if self.use_res else h


class _Encoder(nn.Module):
    """Stem (``conv_stem``, ``bn1``, SiLU) and ``blocks``; subclasses fill both."""

    feature_stages: tuple = ()
    stem_feature: bool = False

    def _trunk(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW input -> the NCHW feature maps."""
        h = F.silu(self.bn1(self.conv_stem(x)))
        feats = [h] if self.stem_feature else []
        for stage_idx, stage in enumerate(self.blocks):
            h = stage(h)
            if stage_idx in self.feature_stages:
                feats.append(h)
        return feats

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NHWC input -> five NHWC feature maps at strides 2, 4, 8, 16 and 32."""
        return [f.permute(0, 2, 3, 1) for f in self._trunk(x.permute(0, 3, 1, 2))]


class EfficientNetEncoder(_Encoder):
    """EfficientNet trunk returning [stem (/2), stage 2 (/4), 3 (/8), 5 (/16), 7 (/32)] (:120-162).

    Args:
        variant: "efficientnet_b0" to "efficientnet_b7".
        conv_padding: "SAME" (TF, official EfficientNet) or "symmetric" (timm native).
        bn_eps: Batch-norm epsilon (timm native uses 1e-5).
    """

    feature_stages = (1, 2, 4, 6)
    stem_feature = True

    def __init__(self, variant: str = "efficientnet_b0", conv_padding: str = "SAME", bn_eps: float = 1e-3) -> None:
        super().__init__()
        width_mult, depth_mult = EFFICIENTNET_PARAMS[variant]
        in_ch = _round_channels(32, width_mult)
        self.conv_stem = _conv(3, in_ch, 3, 2, conv_padding)
        self.bn1 = nn.BatchNorm2d(in_ch, eps=bn_eps)
        stages = []
        for expand, ch, repeats, kernel, stride in _B0_BLOCKS:
            out_ch = _round_channels(ch, width_mult)
            blocks = []
            for block_idx in range(_round_repeats(repeats, depth_mult)):
                s = stride if block_idx == 0 else 1
                blocks.append(MBConv(in_ch, out_ch, expand, kernel, s, conv_padding, bn_eps))
                in_ch = out_ch
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.variant = variant
        self.out_channels = in_ch


# EfficientNetV2 stage plans (timm arch defs):
# (block_type, expand, channels, repeats, kernel, stride)
EFFICIENTNETV2_CONFIGS = {
    "efficientnetv2_s": {
        "stem": 24,
        "stages": (
            ("cn", 1, 24, 2, 3, 1),
            ("er", 4, 48, 4, 3, 2),
            ("er", 4, 64, 4, 3, 2),
            ("ir", 4, 128, 6, 3, 2),
            ("ir", 6, 160, 9, 3, 1),
            ("ir", 6, 256, 15, 3, 2),
        ),
        "feature_stages": (0, 1, 2, 4, 5),
    },
    "efficientnetv2_m": {
        "stem": 24,
        "stages": (
            ("cn", 1, 24, 3, 3, 1),
            ("er", 4, 48, 5, 3, 2),
            ("er", 4, 80, 5, 3, 2),
            ("ir", 4, 160, 7, 3, 2),
            ("ir", 6, 176, 14, 3, 1),
            ("ir", 6, 304, 18, 3, 2),
            ("ir", 6, 512, 5, 3, 1),
        ),
        "feature_stages": (0, 1, 2, 4, 6),
    },
    "efficientnetv2_l": {
        "stem": 32,
        "stages": (
            ("cn", 1, 32, 4, 3, 1),
            ("er", 4, 64, 7, 3, 2),
            ("er", 4, 96, 7, 3, 2),
            ("ir", 4, 192, 10, 3, 2),
            ("ir", 6, 224, 19, 3, 1),
            ("ir", 6, 384, 25, 3, 2),
            ("ir", 6, 640, 7, 3, 1),
        ),
        "feature_stages": (0, 1, 2, 4, 6),
    },
}


class EfficientNetV2Encoder(_Encoder):
    """EfficientNetV2 trunk returning 5 features at strides 2, 4, 8, 16, 32 (:264-311).

    timm's ``tf_efficientnetv2_*`` (TF "SAME" padding, BN eps 1e-3, SiLU).
    """

    def __init__(self, variant: str = "efficientnetv2_l", conv_padding: str = "SAME", bn_eps: float = 1e-3) -> None:
        super().__init__()
        cfg = EFFICIENTNETV2_CONFIGS[variant]
        in_ch = cfg["stem"]
        self.conv_stem = _conv(3, in_ch, 3, 2, conv_padding)
        self.bn1 = nn.BatchNorm2d(in_ch, eps=bn_eps)
        stages = []
        for kind, expand, ch, repeats, kernel, stride in cfg["stages"]:
            blocks = []
            for block_idx in range(repeats):
                s = stride if block_idx == 0 else 1
                if kind == "cn":
                    blocks.append(ConvBnAct(in_ch, ch, kernel, s, conv_padding, bn_eps))
                elif kind == "er":
                    blocks.append(FusedMBConv(in_ch, ch, expand, kernel, s, conv_padding, bn_eps))
                else:
                    blocks.append(MBConv(in_ch, ch, expand, kernel, s, conv_padding, bn_eps))
                in_ch = ch
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.feature_stages = cfg["feature_stages"]
        self.variant = variant
        self.out_channels = in_ch


class EfficientNetClassifier(EfficientNetEncoder):
    """EfficientNet with head conv, global average pooling and a linear classifier (:314-335).

    ``num_classes=0`` returns the pooled head features (timm's
    feature-extractor convention, used by ``TimmBackbone`` and ``TimmModel``).
    """

    def __init__(self, variant: str = "efficientnet_b0", num_classes: int = 1000) -> None:
        super().__init__(variant)
        head_ch = _round_channels(1280, EFFICIENTNET_PARAMS[variant][0])
        self.conv_head = nn.Conv2d(self.out_channels, head_ch, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(head_ch, eps=1e-3)
        self.num_classes = num_classes
        self.num_features = head_ch
        if num_classes:
            self.classifier = nn.Linear(head_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input -> pooled features ``[N, head]``, or logits with classes."""
        last = self._trunk(x.permute(0, 3, 1, 2))[-1]
        h = F.silu(self.bn2(self.conv_head(last))).mean(dim=(2, 3))
        return self.classifier(h) if self.num_classes else h


EFFICIENTNET_STAGE_CHANNELS = {
    variant: [
        _round_channels(32, wm),
        _round_channels(24, wm),
        _round_channels(40, wm),
        _round_channels(112, wm),
        _round_channels(320, wm),
    ]
    for variant, (wm, _) in EFFICIENTNET_PARAMS.items()
}
