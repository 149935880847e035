"""KongNet (counterpart of ``tiatoolbox_tpu/models/architecture/kongnet.py:1-242``).

Multi-head nucleus detection: a shared EfficientNetV2-L encoder
(``efficientnet.EfficientNetV2Encoder``, timm's ``tf_efficientnetv2_l``:
TF "SAME" padding, batch-norm eps 1e-3, SiLU) feeds ``num_heads`` U-Net
decoders, each ending in a 1x1 head; the heads' outputs are concatenated on
the channels. Each decoder (``_KongNetDecoder`` :110-120) puts an SCSE
attention (:50-61) on the stride-32 feature, then five blocks
(``_DecoderBlock`` :92-107): a sub-pixel upsample (1x1 conv to 4x the
channels, ``F.pixel_shuffle(2)``, 3x3 conv; each conv without bias, then a
batch norm with eps 1e-5 and SiLU, :64-89), the skip concatenated and an
SCSE over both (only where a skip exists), two 3x3 conv-BN-SiLU and an SCSE.
The widths are (256, 128, 64, 32, 16), or (512, 256, 128, 64, 32) with
``wide_decoder``.

Modules carry the upstream torch names that ``torch_kongnet_to_flax``
(``weight_converter.py:798-909``) reads: the encoder under
``encoder.model.*`` with timm's names, ``decoders.I.center.attention.attention``
and ``decoders.I.blocks.J.{up.conv1, up.conv2, attention1.attention,
conv1, conv2, attention2.attention}``, the SCSE convolutions as ``cSE.1``,
``cSE.3`` and ``sSE.0``, and the heads as ``heads.I.0``.

``preproc`` normalises with the ImageNet statistics on the host (:202-205),
so the semantic engine takes the per-patch feed; ``infer_batch_device``
returns the sigmoid of the ``target_channels`` in float32 (:207-219), NHWC
on the device; ``postproc`` keeps each channel's peaks after NMS (:221-242).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import init_backbone_weights
from tiatoolbox_tpu_torch.models.architecture.efficientnet import (
    EFFICIENTNET_STAGE_CHANNELS,
    EFFICIENTNETV2_CONFIGS,
    EfficientNetEncoder,
    EfficientNetV2Encoder,
)
from tiatoolbox_tpu_torch.models.architecture.utils import (
    nms_on_detection_maps,
    peak_detection_map_overlap,
)
from tiatoolbox_tpu_torch.models.models_abc import ModelABC

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])
DECODER_CHANNELS = (256, 128, 64, 32, 16)
WIDE_DECODER_CHANNELS = (512, 256, 128, 64, 32)


def imagenet_normalise(image: np.ndarray) -> np.ndarray:
    """``(image / 255 - mean) / std`` in float64, cast to float32."""
    return ((image / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


class SCSEAttention(nn.Module):
    """Channel squeeze-excite (reduction 16) plus spatial squeeze-excite:
    ``x * sigmoid(cSE) + x * sigmoid(sSE)`` (:50-61)."""

    def __init__(self, channels: int, reduction: int = 16) -> None:
        super().__init__()
        squeeze = max(channels // reduction, 1)
        self.cSE = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(channels, squeeze, 1),
            nn.ReLU(),
            nn.Conv2d(squeeze, channels, 1),
            nn.Sigmoid(),
        )
        self.sSE = nn.Sequential(nn.Conv2d(channels, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.cSE(x) + x * self.sSE(x)


class _Attention(nn.Module):
    """The upstream wrapper that holds an SCSE under ``attention``."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.attention = SCSEAttention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(x)


class _Center(nn.Module):
    """The centre block: an SCSE on the deepest feature, under ``attention``."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.attention = _Attention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(x)


def conv_bn_silu(in_ch: int, out_ch: int, kernel: int) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: conv without bias, BN eps 1e-5, SiLU (:73-89)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, bias=False),
        nn.BatchNorm2d(out_ch, eps=1e-5),
        nn.SiLU(),
    )


class _SubPixelUpsample(nn.Module):
    """1x1 conv to 4x the channels, pixel shuffle 2x, 3x3 conv (:97-101)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv1 = conv_bn_silu(channels, channels * 4, 1)
        self.conv2 = conv_bn_silu(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.pixel_shuffle(self.conv1(x), 2))


class _DecoderBlock(nn.Module):
    """Upsample, concat the skip and SCSE (with a skip only), two conv-BN-SiLU, SCSE (:92-107)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int) -> None:
        super().__init__()
        self.up = _SubPixelUpsample(in_ch)
        if skip_ch:
            self.attention1 = _Attention(in_ch + skip_ch)
        self.conv1 = conv_bn_silu(in_ch + skip_ch, out_ch, 3)
        self.conv2 = conv_bn_silu(out_ch, out_ch, 3)
        self.attention2 = _Attention(out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
        x = self.up(x)
        if skip is not None:
            x = self.attention1(torch.cat([x, skip], dim=1))
        return self.attention2(self.conv2(self.conv1(x)))


class _KongNetDecoder(nn.Module):
    """Centre SCSE on the stride-32 feature, then five decoder blocks (:110-120)."""

    def __init__(self, encoder_channels, decoder_channels) -> None:
        super().__init__()
        self.center = _Center(encoder_channels[-1])
        in_chs = [encoder_channels[-1], *decoder_channels[:-1]]
        skip_chs = [*encoder_channels[-2::-1], 0]
        self.blocks = nn.ModuleList(
            _DecoderBlock(i, s, o) for i, s, o in zip(in_chs, skip_chs, decoder_channels)
        )

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        h = self.center(feats[-1])
        skips = [*feats[-2::-1], None]
        for block, skip in zip(self.blocks, skips):
            h = block(h, skip)
        return h


class _TimmEncoder(nn.Module):
    """Holds the encoder under ``model``, as upstream's timm wrapper does."""

    def __init__(self, variant: str) -> None:
        super().__init__()
        if variant.startswith("efficientnetv2"):
            self.model = EfficientNetV2Encoder(variant)
        else:  # the v1 family (:133-136)
            self.model = EfficientNetEncoder(variant)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW input -> five NCHW features at strides 2, 4, 8, 16 and 32."""
        return self.model._trunk(x)


def encoder_channels(variant: str) -> list[int]:
    """Channels of the five encoder features of ``variant``."""
    if variant in EFFICIENTNETV2_CONFIGS:
        cfg = EFFICIENTNETV2_CONFIGS[variant]
        return [cfg["stages"][s][2] for s in cfg["feature_stages"]]
    return list(EFFICIENTNET_STAGE_CHANNELS[variant])


class KongNet(ModelABC):
    """Multi-head nucleus detection and classification model.

    Args:
        num_heads: Number of decoder heads.
        num_channels_per_head: Output channels of each head.
        target_channels: Channels kept (and passed through a sigmoid) at inference.
        min_distance / threshold_abs: Peak detection parameters.
        tile_shape: Post-processing tile shape of the registry entry.
        variant: Encoder variant (the registry's is EfficientNetV2-L).
        wide_decoder: Decoder widths (512, 256, 128, 64, 32).
        class_dict: Channel id -> class name.
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator``, on the model's device, that
            the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_heads: int,
        num_channels_per_head,
        target_channels,
        min_distance: int,
        threshold_abs: float,
        tile_shape=(2048, 2048),
        variant: str = "efficientnetv2_l",
        *,
        wide_decoder: bool = False,
        class_dict: dict | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        if len(num_channels_per_head) != num_heads:
            msg = (
                f"Number of decoders {len(num_channels_per_head)} must match "
                f"number of heads {num_heads}."
            )
            raise ValueError(msg)
        super().__init__(compute_dtype)
        self.min_distance = min_distance
        self.threshold_abs = threshold_abs
        self.target_channels = list(target_channels)
        self.class_dict = class_dict
        self.tile_shape = tile_shape
        self.variant = variant
        self.tasks = ["nuclei_detection"]
        widths = WIDE_DECODER_CHANNELS if wide_decoder else DECODER_CHANNELS
        enc_ch = encoder_channels(variant)
        dev = resolve_device(device)
        with torch.device(dev):
            self.encoder = _TimmEncoder(variant)
            self.decoders = nn.ModuleList(_KongNetDecoder(enc_ch, widths) for _ in range(num_heads))
            self.heads = nn.ModuleList(
                nn.Sequential(nn.Conv2d(widths[-1], int(c), 1)) for c in num_channels_per_head
            )
        init_backbone_weights(self, torch.Generator(dev).manual_seed(seed))
        self.place(dev)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch (``preproc``'s) -> NHWC logits of every head."""
        feats = self.encoder(batch.permute(0, 3, 1, 2))
        logits = torch.cat([head(dec(feats)) for dec, head in zip(self.decoders, self.heads)], dim=1)
        return logits.permute(0, 2, 3, 1)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """ImageNet normalisation to float32 (``kongnet.py:202``)."""
        return imagenet_normalise(image)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "KongNet", batch_data, device=None) -> torch.Tensor:
        """Float NHWC batch -> float32 sigmoid of the target channels, NHWC on
        the device, unsynced (``kongnet.py:207``)."""
        if device is not None:
            model.to(resolve_device(device))
        logits = model(model.stage_batch(batch_data).to(model.compute_dtype))
        target = torch.tensor(model.target_channels, device=logits.device)
        return torch.sigmoid(logits.index_select(-1, target).float()).contiguous()

    @classmethod
    def infer_batch(cls, model: "KongNet", batch_data, device=None) -> np.ndarray:
        """As ``infer_batch_device``, fetched."""
        return cls.infer_batch_device(model, batch_data, device).cpu().numpy()

    def postproc(
        self, block: np.ndarray, min_distance: int | None = None, threshold_abs: float | None = None, **_kwargs
    ) -> np.ndarray:
        """1.0 at each channel's peaks that survive NMS, HWC in and out (``kongnet.py:221``)."""
        block = np.asarray(block)
        min_distance = self.min_distance if min_distance is None else min_distance
        threshold_abs = self.threshold_abs if threshold_abs is None else threshold_abs
        out = np.zeros_like(block, dtype=np.float32)
        for c in range(block.shape[-1]):
            coords = peak_detection_map_overlap(block[..., c], min_distance=min_distance, threshold_abs=threshold_abs)
            if len(coords):
                scores = block[coords[:, 0], coords[:, 1], c]
                kept = coords[nms_on_detection_maps(coords, scores, radius=min_distance)]
                out[kept[:, 0], kept[:, 1], c] = 1.0
        return out
