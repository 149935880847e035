"""SCCNN (counterpart of ``tiatoolbox_tpu/models/architecture/sccnn.py:1-130``).

The spatially constrained CNN: valid convolutions l1-l5 with ReLUs and
two 2x2 max pools, and the ``sc`` head whose sigmoids give a row, a column
and a confidence. Its S2 layer renders, over the output window, the bump
``s2 / (1 + d^2 / 2)`` where the squared distance ``d^2`` to the predicted
location is below ``radius``, in plain torch operations inside the
forward. Modules carry upstream's names (``layer.l1.conv1.0``, ...,
``layer.sc.conv1.0``); the row and column grids ``xv`` and ``yv`` are
buffers computed here and left out of the ``state_dict`` (a reference
``.pth``'s are dropped on load, as ``torch_sccnn_to_flax`` skips them,
:473-487).

``preproc`` divides by 255 on the host, to float32; being SCCNN's own
function, it makes the semantic engine refuse the region feed, as JAX's
does. ``postproc`` marks each channel's peaks.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.models.architecture.micronet import seeded_init
from tiatoolbox_tpu_torch.models.architecture.utils import peak_map
from tiatoolbox_tpu_torch.models.models_abc import ModelABC


def _conv_act(in_ch: int, out_ch: int, ksize: int, act: nn.Module) -> nn.ModuleDict:
    return nn.ModuleDict({"conv1": nn.Sequential(nn.Conv2d(in_ch, out_ch, ksize, bias=True), act)})


class SCCNN(ModelABC):
    """Spatially constrained CNN nucleus detector.

    Args:
        num_input_channels: Input channels.
        patch_output_shape: (height, width) of the rendered output map.
        radius: Squared-distance threshold of the probability bump.
        min_distance / threshold_abs: Peak detection parameters.
        tile_shape: Post-processing tile shape of the registry entry.
        class_dict: id -> class name.
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator`` the random weights come from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_input_channels: int = 3,
        patch_output_shape=(13, 13),
        radius: int = 12,
        min_distance: int = 6,
        threshold_abs: float = 0.20,
        tile_shape=(2048, 2048),
        class_dict: dict | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(compute_dtype)
        self.in_ch = num_input_channels
        self.out_height, self.out_width = int(patch_output_shape[0]), int(patch_output_shape[1])
        self.radius = radius
        self.tasks = ["nuclei_detection"]
        self.min_distance = min_distance
        self.threshold_abs = threshold_abs
        self.tile_shape = tile_shape
        self.class_dict = class_dict
        self.layer = nn.ModuleDict(
            OrderedDict(
                [
                    ("l1", _conv_act(num_input_channels, 30, 2, nn.ReLU())),
                    ("pool1", nn.MaxPool2d(2)),
                    ("l2", _conv_act(30, 60, 2, nn.ReLU())),
                    ("pool2", nn.MaxPool2d(2)),
                    ("l3", _conv_act(60, 90, 3, nn.ReLU())),
                    ("l4", _conv_act(90, 1024, 5, nn.ReLU())),
                    ("dropout1", nn.Dropout2d(p=0.5)),
                    ("l5", _conv_act(1024, 512, 1, nn.ReLU())),
                    ("dropout2", nn.Dropout2d(p=0.5)),
                    ("sc", _conv_act(512, 3, 1, nn.Sigmoid())),
                ]
            )
        )
        xv, yv = torch.meshgrid(
            torch.arange(self.out_height, dtype=torch.float32),
            torch.arange(self.out_width, dtype=torch.float32),
            indexing="ij",
        )
        self.register_buffer("xv", xv[None, None], persistent=False)
        self.register_buffer("yv", yv[None, None], persistent=False)
        seeded_init(self, seed)
        self.place(device)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC batch in [0, 1] -> NHWC ``[N, out_h, out_w, 1]`` bump map."""
        h = batch.permute(0, 3, 1, 2)
        for name in ("l1", "pool1", "l2", "pool2", "l3", "l4", "dropout1", "l5", "dropout2", "sc"):
            module = self.layer[name]
            h = module["conv1"](h) if isinstance(module, nn.ModuleDict) else module(h)
        s0 = h[:, 0:1] * (self.out_height - 1)
        s1 = h[:, 1:2] * (self.out_width - 1)
        s2 = h[:, 2:3]
        out_map = (self.xv - s0) ** 2 + (self.yv - s1) ** 2
        inside = (out_map < self.radius).to(out_map.dtype)
        return (s2 / (1 + out_map / 2) * inside).permute(0, 2, 3, 1)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """``image / 255`` as float32 (``sccnn.py:101``)."""
        return (image / 255.0).astype(np.float32)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "SCCNN", batch_data, device=None) -> torch.Tensor:
        """Float NHWC batch (``preproc``'s) -> NHWC float32 map on the device, unsynced."""
        if device is not None:
            model.to(resolve_device(device))
        x = model.stage_batch(batch_data)
        return model(x.to(model.compute_dtype)).float().contiguous()

    def postproc(
        self, block: np.ndarray, min_distance: int | None = None, threshold_abs: float | None = None, **_kwargs
    ) -> np.ndarray:
        """1.0 at each channel's peaks, HWC in and out (``sccnn.py:118``)."""
        return peak_map(
            block,
            self.min_distance if min_distance is None else min_distance,
            self.threshold_abs if threshold_abs is None else threshold_abs,
        )
