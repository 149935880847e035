"""MicroNet (counterpart of ``tiatoolbox_tpu/models/architecture/micronet.py:1-271``).

Multi-branch nucleus segmentation: four down branches, each fusing a
bicubic-resized copy of the input (128, 64, 32, 16), a bottleneck, four
transpose-convolution up branches with skip fusions, three upsampled
feature maps with auxiliary heads, and a fused output head. Every
convolution is valid, so a 252x252 input gives a 252x252 output. Modules
carry upstream tiatoolbox's names (``layer.b1.conv1.0`` with the batch
norm after the tanh at ``.2``, ``layer.b6.up1``, ``layer.fm1.conv1.0``,
``layer.out.1``), the names ``torch_micronet_to_flax``
(``weight_converter.py:490-552``) reads, so a reference ``.pth`` loads as
it is.

The resizes are ``F.interpolate(mode="bicubic", align_corners=False)``,
the a = -0.75 matrix that JAX's ``_torch_bicubic_resize`` (:48-83)
reproduces. ``preproc`` (:207-215) standardises each patch on the host in
float64; ``postproc`` (:229-271) labels the argmax, drops objects under 50
pixels and fills each instance's holes, then ``HoVerNet.get_instance_info``.
``infer_batch_device`` returns the softmax head, NHWC float32 on the
device; ``infer_batch`` a one-element tuple of it, as JAX's does, so the
multitask engine takes MicroNet as one head.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from torch import nn

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.models.models_abc import ModelABC

RESIZE_SIZES = (128, 64, 32, 16)


def _conv(in_ch: int, out_ch: int, ksize: int, act: nn.Module | None = None, bn: bool = False) -> nn.Sequential:
    """A valid convolution, its activation, and a batch norm after the activation."""
    layers = [nn.Conv2d(in_ch, out_ch, ksize, bias=True)]
    if act is not None:
        layers.append(act)
    if bn:
        layers.append(nn.BatchNorm2d(out_ch, eps=1e-5))
    return nn.Sequential(*layers)


def _group1(in_ch: int, resized_in_ch: int, out_ch: int) -> nn.ModuleDict:
    """Down branch (``micronet.py:86``): two tanh convolutions and a 2x2 pool,
    beside two tanh convolutions of the resized input."""
    return nn.ModuleDict(
        OrderedDict(
            [
                ("conv1", _conv(in_ch, out_ch, 3, nn.Tanh(), bn=True)),
                ("conv2", _conv(out_ch, out_ch, 3, nn.Tanh())),
                ("pool", nn.MaxPool2d(2)),
                ("conv3", _conv(resized_in_ch, out_ch, 3, nn.Tanh(), bn=True)),
                ("conv4", _conv(out_ch, out_ch, 3, nn.Tanh())),
            ]
        )
    )


def _group3(in_ch: int, skip_ch: int, out_ch: int) -> nn.ModuleDict:
    """Up branch (``micronet.py:103``): a 2x2 transpose convolution and two tanh
    convolutions, fused with the skip through 5x5 transpose convolutions."""
    return nn.ModuleDict(
        OrderedDict(
            [
                ("up1", nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2)),
                ("conv1", _conv(out_ch, out_ch, 3, nn.Tanh())),
                ("conv2", _conv(out_ch, out_ch, 3, nn.Tanh())),
                ("up2", nn.ConvTranspose2d(out_ch, out_ch, 5)),
                ("up3", nn.ConvTranspose2d(skip_ch, out_ch, 5)),
                ("conv3", _conv(2 * out_ch, out_ch, 1, nn.Tanh())),
            ]
        )
    )


def _group4(in_ch: int, out_ch: int, up: int, act: str) -> nn.ModuleDict:
    """Feature map branch (``micronet.py:143``): an up x up transpose convolution
    and a 3x3 convolution with ReLU or tanh."""
    return nn.ModuleDict(
        OrderedDict(
            [
                ("up1", nn.ConvTranspose2d(in_ch, out_ch, up, stride=up)),
                ("conv1", _conv(out_ch, out_ch, 3, nn.ReLU() if act == "relu" else nn.Tanh())),
            ]
        )
    )


def _out_head(in_ch: int, out_ch: int, act: str) -> nn.Sequential:
    """Output head (``micronet.py:149``): dropout (off in eval mode), a 3x3
    convolution, ReLU or a softmax over the channels."""
    return nn.Sequential(
        nn.Dropout2d(p=0.5),
        nn.Conv2d(in_ch, out_ch, 3, bias=True),
        nn.ReLU() if act == "relu" else nn.Softmax(dim=1),
    )


def micronet_layers(num_input_channels: int, num_output_channels: int, out_activation: str) -> nn.ModuleDict:
    """The MicroNet modules under upstream's names (``micronet.py:132-196``)."""
    c = num_input_channels
    bottleneck = OrderedDict(
        [("conv1", _conv(1024, 2048, 3, nn.Tanh())), ("conv2", _conv(2048, 2048, 3, nn.Tanh()))]
    )
    return nn.ModuleDict(
        OrderedDict(
            [
                ("b1", _group1(c, c, 64)),
                ("b2", _group1(128, c, 128)),
                ("b3", _group1(256, c, 256)),
                ("b4", _group1(512, c, 512)),
                ("b5", nn.ModuleDict(bottleneck)),
                ("b6", _group3(2048, 1024, 1024)),
                ("b7", _group3(1024, 512, 512)),
                ("b8", _group3(512, 256, 256)),
                ("b9", _group3(256, 128, 128)),
                ("fm1", _group4(128, 64, 2, out_activation)),
                ("fm2", _group4(256, 128, 4, out_activation)),
                ("fm3", _group4(512, 256, 8, out_activation)),
                ("aux_out1", _out_head(64, num_output_channels, "softmax")),
                ("aux_out2", _out_head(128, num_output_channels, "softmax")),
                ("aux_out3", _out_head(256, num_output_channels, "softmax")),
                ("out", _out_head(64 + 128 + 256, num_output_channels, out_activation)),
            ]
        )
    )


def _down(branch: nn.ModuleDict, x: torch.Tensor, resized: torch.Tensor) -> torch.Tensor:
    a = branch["pool"](branch["conv2"](branch["conv1"](x)))
    b = branch["conv4"](branch["conv3"](resized))
    return torch.cat([a, b], dim=1)


def _up(branch: nn.ModuleDict, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    a = branch["conv2"](branch["conv1"](branch["up1"](x)))
    return branch["conv3"](torch.cat([branch["up2"](a), branch["up3"](skip)], dim=1))


def micronet_forward(layer: nn.ModuleDict, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """NCHW input -> ``(out, aux1, aux2, aux3)``, NCHW (``micronet.py:132-171``)."""
    resized = [F.interpolate(x, size=(s, s), mode="bicubic", align_corners=False) for s in RESIZE_SIZES]
    b1 = _down(layer["b1"], x, resized[0])
    b2 = _down(layer["b2"], b1, resized[1])
    b3 = _down(layer["b3"], b2, resized[2])
    b4 = _down(layer["b4"], b3, resized[3])
    b5 = layer["b5"]["conv2"](layer["b5"]["conv1"](b4))
    b6 = _up(layer["b6"], b5, b4)
    b7 = _up(layer["b7"], b6, b3)
    b8 = _up(layer["b8"], b7, b2)
    b9 = _up(layer["b9"], b8, b1)
    fm = [layer[f"fm{i}"]["conv1"](layer[f"fm{i}"]["up1"](feat)) for i, feat in ((1, b9), (2, b8), (3, b7))]
    aux = [layer[f"aux_out{i + 1}"](f) for i, f in enumerate(fm)]
    return (layer["out"](torch.cat(fm, dim=1)), *aux)


def seeded_init(module: nn.Module, seed: int) -> None:
    """PyTorch's default convolution initialisation, drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=gen)
            bound = 1 / math.sqrt(nn.init._calculate_fan_in_and_fan_out(m.weight)[0])
            nn.init.uniform_(m.bias, -bound, bound, generator=gen)


class MicroNet(ModelABC):
    """Nucleus segmentation MicroNet (canonical input 252x252).

    Args:
        num_input_channels: Input channels.
        num_output_channels: Output classes (>= 2).
        out_activation: "softmax" or "relu" (MapDe's trunk).
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator`` the random weights come from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_input_channels: int = 3,
        num_output_channels: int = 2,
        out_activation: str = "softmax",
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        if num_output_channels < 2:
            msg = "Number of classes should be >=2."
            raise ValueError(msg)
        super().__init__(compute_dtype)
        self.in_ch = num_input_channels
        self.tasks = ["nuclei_segmentation"]
        self.layer = micronet_layers(num_input_channels, num_output_channels, out_activation)
        seeded_init(self, seed)
        self.place(device)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch (``preproc``'s standardised patches) -> NHWC softmax map."""
        return micronet_forward(self.layer, batch.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """Per-image standardisation in float64 (``micronet.py:207``)."""
        image = image.astype(np.float64) / 255.0
        mean = image.mean()
        stddev = image.std(ddof=1)
        min_stddev = 1.0 / np.sqrt(image.size)
        adjusted = max(stddev, min_stddev)
        return ((image - mean) / adjusted).astype(np.float32)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "MicroNet", batch_data, device=None) -> torch.Tensor:
        """Float NHWC batch -> NHWC float32 map on the device, unsynced (no /255:
        the batch comes from ``preproc``)."""
        if device is not None:
            model.to(resolve_device(device))
        x = model.stage_batch(batch_data)
        return model(x.to(model.compute_dtype)).float().contiguous()

    @classmethod
    def infer_batch(cls, model: "MicroNet", batch_data, device=None) -> tuple[np.ndarray]:
        """As ``infer_batch_device``, fetched: a one-element tuple (``micronet.py:218``)."""
        return (cls.infer_batch_device(model, batch_data, device).cpu().numpy(),)

    def postproc(self, raw_maps, offset=(0, 0)) -> tuple:
        """Instances of ``raw_maps[0]``: argmax, label, drop objects under 50
        pixels, fill each instance's holes (``micronet.py:229``)."""
        from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet, _remove_small_objects, instance_columns

        pred_bin = np.argmax(np.asarray(raw_maps[0]), axis=2)
        pred_inst = ndimage.label(pred_bin)[0]
        pred_inst = _remove_small_objects(pred_inst, min_size=50)
        canvas = np.zeros(pred_inst.shape[:2], dtype=np.int32)
        max_value = 0 if not np.any(pred_inst) else int(pred_inst.max())
        for idx, slc in enumerate(ndimage.find_objects(pred_inst, max_label=max_value)):
            if slc is None:
                continue
            filled = ndimage.binary_fill_holes(pred_inst[slc] == idx + 1)
            canvas[slc][filled] = idx + 1
        info_dict = HoVerNet.get_instance_info(canvas, offset=np.asarray(offset))
        return (
            {
                "task_type": self.tasks[0],
                "predictions": pred_inst,
                "info_dict": instance_columns(info_dict),
                "seg_type": "instance",
            },
        )
