"""NuClick (counterpart of ``tiatoolbox_tpu/models/architecture/nuclick.py:1-249``).

Interactive nucleus segmentation: an RGB patch and its inclusion and
exclusion click maps (5 input channels) give one mask channel. The trunk
(``_NuClickNet`` :95-163) is a U-Net of ``ConvBnRelu`` (a conv with "SAME"
padding and optional dilation, BN eps 1e-5, ReLU, :34-57),
``MultiscaleConvBlock`` (four dilated convs concatenated, :60-79) and
``ResidualConv`` (two conv-BN, ``relu(c1 + c2)``, :82-92), with 2x2 max
pools and 2x2 stride-2 transpose convolutions. Names are upstream's, as
``torch_nuclick_to_flax`` (``weight_converter.py:555-628``) reads them:
``conv_block_1.{0,1,2}.conv_bn_relu.{0,1}``, ``residual_block_N`` (a
sequence ``residual_block_N.M.conv_block_{1,2}`` or one block
``residual_block_N.conv_block_{1,2}``), ``multiscale_block_N.conv_block_{1-4}``,
``conv_transpose_N`` and ``conv_block_3.conv_bn_relu.0``.

``infer_batch_device`` returns the sigmoid of channel 0, ``[N, H, W]``
float32 (:188-199); ``postproc`` (:201-249) thresholds, drops objects under
``min_size`` pixels, fills interior holes under ``min_hole_size`` pixels and,
with ``do_reconstruction``, keeps the objects under each image's clicks.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage
from torch import nn

from tiatoolbox_tpu_torch import logger, resolve_device
from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import init_backbone_weights
from tiatoolbox_tpu_torch.models.models_abc import ModelABC


class ConvBnRelu(nn.Module):
    """Conv ("SAME", dilated), optional BN (eps 1e-5), optional ReLU, under ``conv_bn_relu``."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel: int = 3,
        dilation: int = 1,
        activation: str | None = "relu",
        use_bias: bool = False,
        do_batchnorm: bool = True,
    ) -> None:
        super().__init__()
        layers: list[nn.Module] = [
            nn.Conv2d(in_ch, out_ch, kernel, padding=dilation * (kernel - 1) // 2, dilation=dilation, bias=use_bias)
        ]
        if do_batchnorm:
            layers.append(nn.BatchNorm2d(out_ch, eps=1e-5))
        if activation == "relu":
            layers.append(nn.ReLU())
        self.conv_bn_relu = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_bn_relu(x)


class MultiscaleConvBlock(nn.Module):
    """Four parallel dilated ``ConvBnRelu`` concatenated on the channels."""

    def __init__(self, in_ch: int, out_ch: int, kernel_sizes, dilation_rates) -> None:
        super().__init__()
        for i in range(4):
            setattr(self, f"conv_block_{i + 1}", ConvBnRelu(in_ch, out_ch, kernel_sizes[i], dilation_rates[i]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"conv_block_{i + 1}")(x) for i in range(4)], dim=1)


class ResidualConv(nn.Module):
    """conv-BN, conv-BN, ``relu(first + second)``."""

    def __init__(self, in_ch: int, out_ch: int) -> None:
        super().__init__()
        self.conv_block_1 = ConvBnRelu(in_ch, out_ch, activation=None)
        self.conv_block_2 = ConvBnRelu(out_ch, out_ch, activation=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.conv_block_1(x)
        return torch.relu(c1 + self.conv_block_2(c1))


def _residual_seq(in_ch: int, widths) -> nn.Sequential:
    blocks = []
    for width in widths:
        blocks.append(ResidualConv(in_ch, width))
        in_ch = width
    return nn.Sequential(*blocks)


def _conv_seq(in_ch: int, specs) -> nn.Sequential:
    """``ConvBnRelu`` layers of (width, kernel) ``specs``."""
    layers = []
    for width, kernel in specs:
        layers.append(ConvBnRelu(in_ch, width, kernel))
        in_ch = width
    return nn.Sequential(*layers)


class NuClick(ModelABC):
    """Click-guided nucleus segmentation.

    Args:
        num_input_channels: Input channels (RGB and two click maps).
        num_output_channels: Output channels.
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator``, on the model's device, that
            the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_input_channels: int = 5,
        num_output_channels: int = 1,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(compute_dtype)
        self.net_name = "NuClick"
        self.n_channels = num_input_channels
        self.n_classes = num_output_channels
        dev = resolve_device(device)
        with torch.device(dev):
            self.conv_block_1 = _conv_seq(num_input_channels, ((64, 7), (32, 5), (32, 3)))
            self.residual_block_1 = _residual_seq(32, (64, 64))
            self.residual_block_2 = ResidualConv(64, 128)
            self.multiscale_block_1 = MultiscaleConvBlock(128, 32, (3, 3, 5, 5), (1, 3, 3, 6))
            self.residual_block_3 = ResidualConv(128, 128)
            self.residual_block_4 = _residual_seq(128, (256, 256, 256))
            self.residual_block_5 = _residual_seq(256, (512, 512, 512))
            self.residual_block_6 = _residual_seq(512, (1024, 1024))
            self.conv_transpose_1 = nn.ConvTranspose2d(1024, 512, 2, stride=2)
            self.residual_block_7 = _residual_seq(1024, (512, 256))
            self.conv_transpose_2 = nn.ConvTranspose2d(256, 256, 2, stride=2)
            self.residual_block_8 = ResidualConv(512, 256)
            self.multiscale_block_2 = MultiscaleConvBlock(256, 64, (3, 3, 5, 5), (1, 3, 2, 3))
            self.residual_block_9 = ResidualConv(256, 256)
            self.conv_transpose_3 = nn.ConvTranspose2d(256, 128, 2, stride=2)
            self.residual_block_10 = _residual_seq(256, (128, 128))
            self.conv_transpose_4 = nn.ConvTranspose2d(128, 64, 2, stride=2)
            self.residual_block_11 = ResidualConv(128, 64)
            self.multiscale_block_3 = MultiscaleConvBlock(64, 16, (3, 3, 5, 7), (1, 3, 2, 6))
            self.residual_block_12 = ResidualConv(64, 64)
            self.conv_transpose_5 = nn.ConvTranspose2d(64, 32, 2, stride=2)
            self.conv_block_2 = _conv_seq(64, ((64, 3), (32, 3), (32, 3)))
            self.conv_block_3 = ConvBnRelu(
                32, num_output_channels, kernel=1, activation=None, use_bias=True, do_batchnorm=False
            )
            self.pool = nn.MaxPool2d(2)
        init_backbone_weights(self, torch.Generator(dev).manual_seed(seed))
        self.place(dev)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch (5 channels) -> NHWC logits at the input size (:95-163)."""
        pool = self.pool
        conv1 = self.conv_block_1(batch.permute(0, 3, 1, 2))
        conv2 = self.residual_block_1(pool(conv1))
        conv3 = self.residual_block_3(self.multiscale_block_1(self.residual_block_2(pool(conv2))))
        conv4 = self.residual_block_4(pool(conv3))
        conv5 = self.residual_block_5(pool(conv4))
        conv51 = self.residual_block_6(pool(conv5))
        conv61 = self.residual_block_7(torch.cat([self.conv_transpose_1(conv51), conv5], dim=1))
        conv6 = self.residual_block_8(torch.cat([self.conv_transpose_2(conv61), conv4], dim=1))
        conv6 = self.residual_block_9(self.multiscale_block_2(conv6))
        conv7 = self.residual_block_10(torch.cat([self.conv_transpose_3(conv6), conv3], dim=1))
        conv8 = self.residual_block_11(torch.cat([self.conv_transpose_4(conv7), conv2], dim=1))
        conv8 = self.residual_block_12(self.multiscale_block_3(conv8))
        conv9 = self.conv_block_2(torch.cat([self.conv_transpose_5(conv8), conv1], dim=1))
        return self.conv_block_3(conv9).permute(0, 2, 3, 1)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "NuClick", batch_data, device=None) -> torch.Tensor:
        """Float NHWC 5-channel batch -> float32 sigmoid of channel 0, ``[N, H, W]``
        on the device, unsynced (:188)."""
        if device is not None:
            model.to(resolve_device(device))
        logits = model(model.stage_batch(batch_data).to(model.compute_dtype))
        return torch.sigmoid(logits.float())[..., 0].contiguous()

    @classmethod
    def infer_batch(cls, model: "NuClick", batch_data, device=None) -> np.ndarray:
        """As ``infer_batch_device``, fetched."""
        return cls.infer_batch_device(model, batch_data, device).cpu().numpy()

    @staticmethod
    def postproc(
        preds: np.ndarray,
        thresh: float = 0.33,
        min_size: int = 10,
        min_hole_size: int = 30,
        nuc_points: np.ndarray | None = None,
        *,
        do_reconstruction: bool = False,
    ) -> np.ndarray:
        """Threshold, small-object and interior small-hole removal, and the
        objects under the clicks with ``do_reconstruction`` (:201-249)."""
        from tiatoolbox_tpu_torch.models.architecture.hovernet import _remove_small_objects

        masks = np.asarray(preds) > thresh
        out = np.zeros_like(masks, dtype=bool)
        for i in range(len(masks)):
            labelled = _remove_small_objects(ndimage.label(masks[i])[0], min_size=min_size)
            mask = labelled > 0
            holes = ndimage.label(~mask)[0]
            small_holes = np.bincount(holes.ravel()) < min_hole_size
            small_holes[0] = False
            # only interior holes: none that touches the border
            border = np.unique(np.concatenate([holes[0], holes[-1], holes[:, 0], holes[:, -1]]))
            small_holes[border] = False
            mask = mask | small_holes[holes]
            if do_reconstruction and nuc_points is not None:
                marker = nuc_points[i] > 0
                if np.any(mask[marker]):
                    comp = ndimage.label(mask)[0]
                    keep = np.unique(comp[marker])
                    mask = np.isin(comp, keep[keep > 0])
                else:
                    logger.warning("No nuclei found at the click point; returning raw mask.")
            out[i] = mask
        return out
