"""GrandQC tissue detection (counterpart of ``tiatoolbox_tpu/models/architecture/grandqc.py:1-165``).

A UNet++ decoder over a timm-native EfficientNet-B0
(``efficientnet.EfficientNetEncoder`` with ``conv_padding="symmetric"`` and
``bn_eps=1e-5``) and a 3x3 head with bias; ``infer_batch_device`` returns
the float32 softmax over the channels (:155-165).

The decoder (``_UnetPlusPlusDecoder`` :58-94) is the dense grid of blocks
``x_{d}_{l}``: the encoder features reversed (320, 112, 40, 24 and 32
channels, deepest first), each block a nearest 2x upsample of its input, the
concatenation of its dense skips, and two 3x3 conv-BN(1e-5)-ReLU
(``grandqc.UNetDecoderBlock``); block ``x_0_l`` is ``decoder_channels[l]``
wide and ``x_d_l`` for d > 0 as wide as feature ``l + 1``; the last block
``x_0_4`` has no skip. Names are upstream's, as ``torch_grandqc_to_flax``
(``weight_converter.py:719-797``) reads them: ``encoder.conv_stem/bn1/
blocks.S.B.*`` with timm's names, ``decoder.blocks.x_D_L.conv{1,2}.{0,1}``
and ``segmentation_head.0``.

``preproc`` (:140-148) is a JPEG round trip at quality 80 and the ImageNet
normalisation. Upstream hands the RGB array to ``cv2.imencode``, which
takes it for BGR, and gets the same channel order back from
``cv2.imdecode``; the port's codec takes true RGB and writes what
``cv2.imencode`` writes of its BGR flip, so the port encodes the flipped
array and flips the decoded pixels back: the same bytes and pixels.
``postproc`` is the argmin over the channels (:150-153).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tiatoolbox_tpu_torch import native, resolve_device
from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import init_backbone_weights
from tiatoolbox_tpu_torch.models.architecture.efficientnet import EfficientNetEncoder
from tiatoolbox_tpu_torch.models.architecture.efficientunet_tissue_mask_model import UNetDecoderBlock
from tiatoolbox_tpu_torch.models.architecture.kongnet import imagenet_normalise
from tiatoolbox_tpu_torch.models.models_abc import ModelABC

JPEG_QUALITY = 80
DECODER_CHANNELS = (256, 128, 64, 32, 16)


class _TimmB0Encoder(EfficientNetEncoder):
    """timm-native EfficientNet-B0: NCHW in, the five NCHW features out."""

    def __init__(self) -> None:
        super().__init__("efficientnet_b0", conv_padding="symmetric", bn_eps=1e-5)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self._trunk(x)


class UnetPlusPlusDecoder(nn.Module):
    """The dense ``x_{d}_{l}`` grid of (:58-94); features shallow to deep in."""

    def __init__(self, encoder_channels, decoder_channels=DECODER_CHANNELS) -> None:
        super().__init__()
        feat_ch = list(encoder_channels)[::-1]
        self.depth = n = len(feat_ch) - 1
        width: dict = {}
        blocks: dict = {}
        for layer in range(n):
            for d in range(n - layer):
                li = d + layer
                out = decoder_channels[layer] if d == 0 else feat_ch[li + 1]
                if layer == 0:
                    in_ch = feat_ch[d] + feat_ch[d + 1]
                else:
                    in_ch = width[(d, li - 1)] + sum(width[(i, li)] for i in range(d + 1, li + 1)) + feat_ch[li + 1]
                blocks[f"x_{d}_{li}"] = UNetDecoderBlock(in_ch, out)
                width[(d, li)] = out
        blocks[f"x_0_{n}"] = UNetDecoderBlock(width[(0, n - 1)], decoder_channels[-1])
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        features = feats[::-1]
        n = self.depth
        dense: dict = {}
        for layer in range(n):
            for d in range(n - layer):
                li = d + layer
                block = self.blocks[f"x_{d}_{li}"]
                if layer == 0:
                    dense[(d, d)] = block(features[d], (features[d + 1],))
                else:
                    skips = [dense[(i, li)] for i in range(d + 1, li + 1)]
                    dense[(d, li)] = block(dense[(d, li - 1)], (*skips, features[li + 1]))
        return self.blocks[f"x_0_{n}"](dense[(0, n - 1)])


def jpeg_roundtrip(image: np.ndarray, quality: int = JPEG_QUALITY) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode(".jpg", image, quality), 1)`` of a uint8
    ``[h, w, 3]`` array, whatever its channel order, through the port's codec."""
    stream = native.encode_jpeg(np.ascontiguousarray(image[..., ::-1]), quality=quality)
    return np.ascontiguousarray(native.decode_jpeg(stream)[..., ::-1])


class GrandQCModel(ModelABC):
    """GrandQC tissue detection (UNet++ over EfficientNet-B0).

    Args:
        num_output_channels: Output classes (2: background and tissue).
        class_dict: Class id -> name.
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator``, on the model's device, that
            the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_output_channels: int = 2,
        class_dict: dict | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(compute_dtype)
        self.num_output_channels = num_output_channels
        self.class_dict = class_dict
        self.name = "unetplusplus-efficientnetb0"
        dev = resolve_device(device)
        with torch.device(dev):
            self.encoder = _TimmB0Encoder()
            self.decoder = UnetPlusPlusDecoder([32, 24, 40, 112, 320])
            self.segmentation_head = nn.Sequential(nn.Conv2d(DECODER_CHANNELS[-1], num_output_channels, 3, padding=1))
        init_backbone_weights(self, torch.Generator(dev).manual_seed(seed))
        self.place(dev)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch (``preproc``'s) -> NHWC logits at the input size."""
        feats = self.encoder(batch.permute(0, 3, 1, 2))
        return self.segmentation_head(self.decoder(feats)).permute(0, 2, 3, 1)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """JPEG round trip at quality 80, then ImageNet normalisation (:140)."""
        return imagenet_normalise(jpeg_roundtrip(image))

    @staticmethod
    def postproc(image: np.ndarray) -> np.ndarray:
        """The tissue mask: argmin over the channel probabilities (:150)."""
        return np.argmin(image, axis=-1)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "GrandQCModel", batch_data, device=None) -> torch.Tensor:
        """Float NHWC batch -> float32 softmax, NHWC on the device, unsynced (:155)."""
        if device is not None:
            model.to(resolve_device(device))
        logits = model(model.stage_batch(batch_data).to(model.compute_dtype))
        return torch.softmax(logits.float(), dim=-1).contiguous()

    @classmethod
    def infer_batch(cls, model: "GrandQCModel", batch_data, device=None) -> np.ndarray:
        """As ``infer_batch_device``, fetched."""
        return cls.infer_batch_device(model, batch_data, device).cpu().numpy()
