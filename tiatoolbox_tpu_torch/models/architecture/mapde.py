"""MapDe (counterpart of ``tiatoolbox_tpu/models/architecture/mapde.py:1-130``).

The MicroNet trunk (``micronet.py``) with ReLU heads and ``2 * num_classes``
output channels, then the fixed 11x11 distance cone ``max(0, 1 - r / 5)``
(:19-27) as one library ``F.conv2d`` with SAME padding from the 2C trunk
channels to C maps, then a ReLU. The trunk keeps upstream's ``layer.*``
names; the cone is a buffer computed here and left out of the
``state_dict`` (a reference ``.pth``'s ``dist_filter`` is dropped on load,
as ``torch_mapde_to_flax`` drops it, :629-638).

``preproc`` is MapDe's own identity: the trunk takes raw 0-255 values, so
``infer_batch_device`` casts without dividing by 255. Being MapDe's own
function, it makes the semantic engine refuse the region feed, as JAX's
does. ``postproc`` marks each channel's peaks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tiatoolbox_tpu_torch.models.architecture.micronet import MicroNet, micronet_forward
from tiatoolbox_tpu_torch.models.architecture.utils import peak_map


def dist_filter_11() -> np.ndarray:
    """The 11x11 distance cone ``max(0, 1 - dist / 5)`` (``mapde.py:19``)."""
    yy, xx = np.mgrid[-5:6, -5:6]
    r = np.hypot(yy, xx)
    return np.maximum(1 - r / 5.0, 0).astype(np.float32)


class MapDe(MicroNet):
    """Deconvolving CNN cell detector (Raza et al. 2019).

    Args:
        num_input_channels: Input channels.
        min_distance / threshold_abs: Peak detection parameters.
        num_classes: Number of cell classes.
        tile_shape: Post-processing tile shape of the registry entry.
        class_dict: id -> class name.
        compute_dtype / seed / device: As ``MicroNet``.
    """

    def __init__(
        self,
        num_input_channels: int = 3,
        min_distance: int = 4,
        threshold_abs: float = 250,
        num_classes: int = 1,
        tile_shape=(2048, 2048),
        class_dict: dict | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(
            num_input_channels, num_classes * 2, "relu", compute_dtype=compute_dtype, seed=seed, device="cpu"
        )
        self.tasks = ["nuclei_detection"]
        self.min_distance = min_distance
        self.threshold_abs = threshold_abs
        self.num_classes = num_classes
        self.tile_shape = tile_shape
        self.class_dict = class_dict
        # same cone for every (in = 2C, out = C) pair, as the flax kernel
        cone = torch.from_numpy(dist_filter_11())
        self.register_buffer(
            "dist_filter", cone.expand(num_classes, num_classes * 2, 11, 11).contiguous(), persistent=False
        )
        self.place(device)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC raw 0-255 batch -> NHWC ReLU'd cone-filtered maps."""
        logits = micronet_forward(self.layer, batch.permute(0, 3, 1, 2))[0]
        out = F.conv2d(logits, self.dist_filter, padding=5)
        return F.relu(out).permute(0, 2, 3, 1)

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """The identity: MapDe takes raw [0, 255] values (``mapde.py:97``)."""
        return image

    @classmethod
    def infer_batch(cls, model: "MapDe", batch_data, device=None) -> np.ndarray:
        """As ``infer_batch_device``, fetched (``mapde.py:102``)."""
        return cls.infer_batch_device(model, batch_data, device).cpu().numpy()

    def postproc(
        self, block: np.ndarray, min_distance: int | None = None, threshold_abs: float | None = None, **_kwargs
    ) -> np.ndarray:
        """1.0 at each channel's peaks, HWC in and out (``mapde.py:113``)."""
        return peak_map(
            block,
            self.min_distance if min_distance is None else min_distance,
            self.threshold_abs if threshold_abs is None else threshold_abs,
        )
