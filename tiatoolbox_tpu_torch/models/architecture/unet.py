"""U-Net segmentation models (counterpart of ``tiatoolbox_tpu/models/architecture/unet.py:1-261``).

Encoders: "resnet50", a Bottleneck ResNet returning the stem and per-stage
features (``ResNetEncoder`` :29; conv1 has a bias when the input has other
than 3 channels, the reference quirk), or "unet", double-conv blocks with
2x2 average pooling (``UnetEncoder`` :69). Decoder (``_DecoderBlock`` :94,
``_UNet`` :128): a 1x1 conv on the deepest feature, then per level a
nearest 2x upsample, an add or concat skip and a conv block
(pre-activation for the resnet encoder), and a 1x1 classifier.

``UNetModel`` holds ``_UNet``'s graph itself, under the reference
tiatoolbox names (``backbone``, ``conv1x1``, ``uplist``, ``clf``), so a
reference ``.pth`` ``state_dict`` loads as it is. Inside, tensors are NCHW
in channels_last memory; ``forward`` takes and returns NHWC, as the flax
module does. ``infer_batch_device`` (:236) runs u8 -> compute dtype -> /255
-> forward -> float32 softmax -> 2x bilinear upsample -> centre crop by
half the input size, and returns a contiguous NHWC float32 tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.models.architecture.resnet import ResNet, init_resnet_weights
from tiatoolbox_tpu_torch.models.architecture.utils import (
    centre_crop,
    resize_bilinear,
    upsample2x,
)
from tiatoolbox_tpu_torch.models.models_abc import ModelABC


class ResNetEncoder(ResNet):
    """Bottleneck ResNet (torchvision names) returning ``[stem, layer1..4]`` features."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), num_input_channels: int = 3) -> None:
        super().__init__(layers=layers, block="bottleneck")
        if num_input_channels != 3:
            self.conv1 = nn.Conv2d(num_input_channels, 64, 7, stride=2, padding=3, bias=True)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW input -> NCHW features at 1/2, 1/4, 1/8, 1/16 and 1/32."""
        x0 = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x0)
        feats = [x0]
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            feats.append(x)
        return feats


class UnetEncoder(nn.Module):
    """Double 3x3 conv + BN + ReLU per level, then 2x2 average pooling."""

    def __init__(
        self,
        num_input_channels: int = 3,
        layer_output_channels: Sequence[int] = (64, 128, 256, 512, 1024),
    ) -> None:
        super().__init__()
        self.blocks = nn.ModuleList()
        in_ch = num_input_channels
        for out_ch in layer_output_channels:
            convs = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
                nn.BatchNorm2d(out_ch),
                nn.ReLU(),
                nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
                nn.BatchNorm2d(out_ch),
                nn.ReLU(),
            )
            self.blocks.append(nn.ModuleList([convs, nn.AvgPool2d(2, stride=2)]))
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """NCHW input -> NCHW features, one per level."""
        feats = []
        for level, (convs, pool) in enumerate(self.blocks):
            x = convs(x)
            feats.append(x)
            if level + 1 < len(self.blocks):
                x = pool(x)
        return feats


def _decoder_block(
    kernels: Sequence[int], in_ch: int, out_ch: int, *, pre_activation: bool
) -> nn.Sequential:
    """``_DecoderBlock``: [BN, ReLU, conv] (pre-activation) or [conv, BN, ReLU] per kernel."""
    layers: list[nn.Module] = []
    for ksize in kernels:
        conv = nn.Conv2d(in_ch, out_ch, ksize, padding=(ksize - 1) // 2, bias=False)
        if pre_activation:
            layers += [nn.BatchNorm2d(in_ch), nn.ReLU(), conv]
        else:
            layers += [conv, nn.BatchNorm2d(out_ch), nn.ReLU()]
        in_ch = out_ch
    return nn.Sequential(*layers)


class UNetModel(ModelABC):
    """U-Net semantic segmentation model.

    Args:
        num_input_channels: Input channels.
        num_output_channels: Output classes.
        encoder: "resnet50" or "unet".
        encoder_levels: Channels per level (unet encoder).
        decoder_block: Kernel sizes of each decoder block.
        skip_type: "add" or "concat".
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator`` the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_input_channels: int = 2,
        num_output_channels: int = 2,
        encoder: str = "resnet50",
        encoder_levels: Sequence[int] | None = None,
        decoder_block: Sequence[int] | None = None,
        skip_type: str = "add",
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        encoder, skip_type = encoder.lower(), skip_type.lower()
        if encoder not in ("resnet50", "unet"):
            msg = f"Unknown encoder `{encoder}`"
            raise ValueError(msg)
        if skip_type not in ("add", "concat"):
            msg = f"Unknown type of skip connection: `{skip_type}`"
            raise ValueError(msg)
        super().__init__(compute_dtype)
        self.num_input_channels = num_input_channels
        self.num_output_channels = num_output_channels
        self.skip_type = skip_type
        if encoder == "resnet50":
            self.backbone = ResNetEncoder(num_input_channels=num_input_channels)
            down_ch = [2048, 1024, 512, 256, 64]
        else:
            levels = list(encoder_levels or (64, 128, 256, 512, 1024))
            self.backbone = UnetEncoder(num_input_channels, levels)
            down_ch = levels[::-1]
        self.conv1x1 = nn.Conv2d(down_ch[0], down_ch[1], 1, bias=False)
        self.uplist = nn.ModuleList()
        for idx in range(1, len(down_ch)):
            in_ch = down_ch[idx] * (2 if skip_type == "concat" else 1)
            out_ch = down_ch[idx + 1] if idx + 1 < len(down_ch) else down_ch[idx]
            self.uplist.append(
                _decoder_block(
                    tuple(decoder_block or (3, 3)),
                    in_ch,
                    out_ch,
                    pre_activation=encoder == "resnet50",
                )
            )
        self.clf = nn.Conv2d(out_ch, num_output_channels, 1, bias=True)
        init_resnet_weights(self, torch.Generator().manual_seed(seed))
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m.bias is not None:
                nn.init.zeros_(m.bias)
        self.place(device)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch (already /255) -> NHWC logits at the stem's resolution."""
        feats = self.backbone(batch.permute(0, 3, 1, 2))
        x = self.conv1x1(feats[-1])
        for block, skip in zip(self.uplist, feats[-2::-1]):
            x = upsample2x(x, "NCHW")
            x = x + skip if self.skip_type == "add" else torch.cat([x, skip], dim=1)
            x = block(x)
        return self.clf(x).permute(0, 2, 3, 1)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "UNetModel", batch_data, device=None) -> torch.Tensor:
        """uint8 NHWC batch -> float32 probabilities ``[N, H/2, W/2, C]`` on the device.

        The softmax runs in float32 whatever the compute dtype, as the JAX
        program does (``logits.astype(jnp.float32)``).
        """
        if device is not None:
            model.to(resolve_device(device))
        x = model.stage_batch(batch_data)
        logits = model(x.to(model.compute_dtype) / 255.0)
        probs = resize_bilinear(torch.softmax(logits.float(), dim=-1), 2)
        crop = (x.shape[1] // 2, x.shape[2] // 2)
        probs = centre_crop(probs, (probs.shape[1] - crop[0], probs.shape[2] - crop[1]))
        return probs.contiguous()
