"""EfficientNet-B0 U-Net tissue mask (counterpart of
``tiatoolbox_tpu/models/architecture/efficientunet_tissue_mask_model.py:1-134``).

The encoder is EfficientNet-B0 under ``efficientnet_pytorch``'s names, which
``torch_efficientunet_to_flax`` (``weight_converter.py:640-716``) reads:
``encoder._conv_stem``, ``_bn0`` and a flat list of 16 MBConv blocks
``_blocks.N`` (``_B0_BLOCK_MAP`` :641-647), each with
``_expand_conv``/``_bn0``/``_depthwise_conv``/``_bn1``/``_se_reduce``/
``_se_expand``/``_project_conv``/``_bn2``. Its convolutions pad as XLA's
"SAME" does (``SameConv2d``; upstream's static same padding is the same
pads), batch norms have eps 1e-3, and its features are taken at strides 2,
4, 8, 16 and 32 (32, 24, 40, 112 and 320 channels). The checkpoint also
holds the classifier's ``_conv_head`` and ``_bn1``, which the segmentation
forward does not use: the module holds them, so a strict load succeeds.

The decoder (``decoder.blocks.I.conv{1,2}.{0,1}``) runs five blocks of a
nearest 2x upsample, the skip concatenated, and two 3x3 conv-BN(1e-5)-ReLU,
at widths (256, 128, 64, 32, 16); the head ``segmentation_head.0`` is a 3x3
conv with bias. ``infer_batch_device`` returns its sigmoid in float32
(:122-134). ``postproc`` (:105-120) thresholds at 0.95 and runs OpenCV's
``MORPH_CLOSE`` then ``MORPH_OPEN`` with the 31x31 ellipse, bit for bit in
the port's host C++ (``morphology_close`` and ``morphology_open`` through
``native.morphology``, ``csrc/imgproc.cpp``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tiatoolbox_tpu_torch import native, resolve_device
from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import init_backbone_weights
from tiatoolbox_tpu_torch.models.architecture.efficientnet import _B0_BLOCKS, _conv
from tiatoolbox_tpu_torch.models.architecture.kongnet import imagenet_normalise
from tiatoolbox_tpu_torch.models.models_abc import ModelABC
from tiatoolbox_tpu_torch.tools.tissuemask import ellipse_kernel

MORPH_KERNEL_SIZE = 31
# the flat block index after which each feature of strides 4, 8, 16 and 32 is taken
_FEATURE_BLOCKS = (2, 4, 10, 15)


class _MBConvBlock(nn.Module):
    """``efficientnet_pytorch``'s MBConvBlock: expand, depthwise, squeeze-excite
    (a quarter of the block's input channels), project, identity skip."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int, kernel: int, stride: int) -> None:
        super().__init__()
        expanded = in_ch * expand_ratio
        self.expand = expand_ratio != 1
        if self.expand:
            self._expand_conv = nn.Conv2d(in_ch, expanded, 1, bias=False)
            self._bn0 = nn.BatchNorm2d(expanded, eps=1e-3)
        self._depthwise_conv = _conv(expanded, expanded, kernel, stride, groups=expanded)
        self._bn1 = nn.BatchNorm2d(expanded, eps=1e-3)
        squeeze = max(1, in_ch // 4)
        self._se_reduce = nn.Conv2d(expanded, squeeze, 1)
        self._se_expand = nn.Conv2d(squeeze, expanded, 1)
        self._project_conv = nn.Conv2d(expanded, out_ch, 1, bias=False)
        self._bn2 = nn.BatchNorm2d(out_ch, eps=1e-3)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self._bn0(self._expand_conv(x))) if self.expand else x
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        se = self._se_expand(F.silu(self._se_reduce(h.mean(dim=(2, 3), keepdim=True))))
        h = self._bn2(self._project_conv(h * torch.sigmoid(se)))
        return h + x if self.use_res else h


class EfficientNetB0Encoder(nn.Module):
    """EfficientNet-B0 under ``efficientnet_pytorch``'s names; NCHW in,
    the five NCHW features at strides 2 to 32 out."""

    def __init__(self) -> None:
        super().__init__()
        self._conv_stem = _conv(3, 32, 3, 2)
        self._bn0 = nn.BatchNorm2d(32, eps=1e-3)
        blocks, in_ch = [], 32
        for expand, ch, repeats, kernel, stride in _B0_BLOCKS:
            for idx in range(repeats):
                blocks.append(_MBConvBlock(in_ch, ch, expand, kernel, stride if idx == 0 else 1))
                in_ch = ch
        self._blocks = nn.ModuleList(blocks)
        # the classifier's head: in the checkpoint, unused by the features
        self._conv_head = nn.Conv2d(in_ch, 1280, 1, bias=False)
        self._bn1 = nn.BatchNorm2d(1280, eps=1e-3)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.silu(self._bn0(self._conv_stem(x)))
        feats = [h]
        for idx, block in enumerate(self._blocks):
            h = block(h)
            if idx in _FEATURE_BLOCKS:
                feats.append(h)
        return feats


def conv_bn_relu(in_ch: int, out_ch: int) -> nn.Sequential:
    """A 3x3 conv without bias, BN eps 1e-5, ReLU (upstream's ``Conv2dReLU``)."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False), nn.BatchNorm2d(out_ch, eps=1e-5), nn.ReLU())


class UNetDecoderBlock(nn.Module):
    """Nearest 2x upsample, concat the skips, two 3x3 conv-BN-ReLU."""

    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.conv1 = conv_bn_relu(in_ch, out_ch)
        self.conv2 = conv_bn_relu(out_ch, out_ch)

    def forward(self, x: torch.Tensor, skips=()) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skips:
            x = torch.cat([x, *skips], dim=1)
        return self.conv2(self.conv1(x))


class _UNetDecoder(nn.Module):
    def __init__(self, encoder_channels, decoder_channels) -> None:
        super().__init__()
        in_chs = [encoder_channels[-1], *decoder_channels[:-1]]
        skip_chs = [*encoder_channels[-2::-1], 0]
        self.blocks = nn.ModuleList(
            UNetDecoderBlock(i + s, o) for i, s, o in zip(in_chs, skip_chs, decoder_channels)
        )

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        h = feats[-1]
        for block, skip in zip(self.blocks, [*feats[-2::-1], None]):
            h = block(h, () if skip is None else (skip,))
        return h


def morphology_close(mask: np.ndarray, ksize: int = MORPH_KERNEL_SIZE) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_CLOSE, ellipse(ksize))`` of a 0/1 uint8 mask."""
    return native.morphology(mask, ellipse_kernel((ksize, ksize)), "close")


def morphology_open(mask: np.ndarray, ksize: int = MORPH_KERNEL_SIZE) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_OPEN, ellipse(ksize))`` of a 0/1 uint8 mask."""
    return native.morphology(mask, ellipse_kernel((ksize, ksize)), "open")


class EfficientUNetTissueMaskModel(ModelABC):
    """Tissue mask: an EfficientNet-B0 U-Net, sigmoid, then >= ``threshold``.

    Args:
        num_output_channels: Output channels (1: a binary mask).
        threshold: Probability threshold of the mask (0.95 upstream).
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator``, on the model's device, that
            the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_output_channels: int = 1,
        threshold: float = 0.95,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(compute_dtype)
        self.threshold = threshold
        dev = resolve_device(device)
        with torch.device(dev):
            self.encoder = EfficientNetB0Encoder()
            self.decoder = _UNetDecoder([32, 24, 40, 112, 320], (256, 128, 64, 32, 16))
            self.segmentation_head = nn.Sequential(nn.Conv2d(16, num_output_channels, 3, padding=1))
        init_backbone_weights(self, torch.Generator(dev).manual_seed(seed))
        self.place(dev)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch (``preproc``'s) -> NHWC logits at the input size."""
        feats = self.encoder(batch.permute(0, 3, 1, 2))
        return self.segmentation_head(self.decoder(feats)).permute(0, 2, 3, 1)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """ImageNet normalisation to float32 (:111)."""
        return imagenet_normalise(image)

    def postproc(self, image: np.ndarray) -> np.ndarray:
        """Threshold channel 0, then close and open with the 31x31 ellipse,
        per mask of an ``[H, W, C]`` map or an ``[N, H, W, C]`` batch (:105-120)."""
        binary = (np.asarray(image)[..., 0] >= self.threshold).astype(np.uint8)
        if binary.ndim == 3:
            return np.stack([morphology_open(morphology_close(m)) for m in binary])
        return morphology_open(morphology_close(binary))

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "EfficientUNetTissueMaskModel", batch_data, device=None) -> torch.Tensor:
        """Float NHWC batch -> float32 sigmoid, NHWC on the device, unsynced (:122)."""
        if device is not None:
            model.to(resolve_device(device))
        logits = model(model.stage_batch(batch_data).to(model.compute_dtype))
        return torch.sigmoid(logits.float()).contiguous()

    @classmethod
    def infer_batch(cls, model: "EfficientUNetTissueMaskModel", batch_data, device=None) -> np.ndarray:
        """As ``infer_batch_device``, fetched."""
        return cls.infer_batch_device(model, batch_data, device).cpu().numpy()
