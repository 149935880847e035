"""Read-time post-processors for multiplex slides (counterpart of ``tiatoolbox_tpu/utils/postproc_defs.py:1-125``).

``MultichannelToRGB`` composites an N-channel image into RGB through a
per-channel colour table, copied from JAX: a name -> RGB ``color_dict``
drives the palette, images of fewer than 5 channels pass through (assumed
RGB(A)), a palette one longer than the image drops its last entry as
background autofluorescence, uint16 input is narrowed to uint8, and an
``enhance`` gain scales the composite (a flat ``(H*W, n) @ (n, 3)`` matmul
with the gain folded into the weights).
"""

from __future__ import annotations

import colorsys
import warnings

import numpy as np


class MultichannelToRGB:
    """Composite an [H, W, N] multichannel image to uint8 RGB.

    Args:
        color_dict: Mapping of channel name → RGB tuple in [0, 1],
            in channel order. When None, an evenly spaced HSV palette
            is generated from the first image's channel count.

    Attributes:
        colors: float32 [n, 3] palette derived from ``color_dict``.
        channels: Active channel indices (viewer toggles); None means
            all palette channels.
        enhance: Brightness gain applied to the composite.
        is_validated: Set False (e.g. by the tile server) to force a
            palette-vs-image recheck on the next call.
    """

    def __init__(
        self,
        color_dict: dict[str, tuple[float, float, float]] | None = None,
    ) -> None:
        self._color_dict: dict | None = None
        self.colors: np.ndarray | None = None
        self.channels: list[int] | None = None
        self.enhance: float = 1.0
        self.is_validated: bool = False
        if color_dict is not None:
            self.color_dict = color_dict

    @property
    def color_dict(self) -> dict | None:
        """Channel name → RGB mapping; assigning rebuilds ``colors``."""
        return self._color_dict

    @color_dict.setter
    def color_dict(self, value: dict | None) -> None:
        self._color_dict = value
        if value is not None:
            self.colors = np.asarray(list(value.values()), dtype=np.float32)
            if self.channels is None:
                self.channels = list(range(len(value)))

    def generate_colors(self, n_channels: int) -> np.ndarray:
        """Fill ``color_dict`` with an evenly spaced HSV palette."""
        self.color_dict = {
            f"channel_{i}": colorsys.hsv_to_rgb(i / n_channels, 1.0, 1.0)
            for i in range(n_channels)
        }
        return self.colors

    def validate(self, n: int) -> None:
        """Reconcile the palette length with an n-channel image.

        A palette of n+1 entries is treated as carrying a trailing
        background-autofluorescence entry and truncated (with a
        warning); any other mismatch is an error.
        """
        if self.colors is None:
            msg = "Colors must be initialized before validation."
            raise ValueError(msg)
        n_colors = len(self.colors)
        if self.channels is None:
            self.channels = list(range(n_colors))
        if n_colors == n + 1:
            self.colors = self.colors[:n]
            self.channels = [c for c in self.channels if c < n]
            warnings.warn(
                "Number of channels in image is one less than colors in "
                "color dict. Assuming last channel is background "
                "autofluorescence and ignoring it.",
                stacklevel=2,
            )
        elif n_colors != n:
            msg = (
                f"Number of colors: {n_colors} does not match channels "
                f"in image: {n}."
            )
            raise ValueError(msg)
        self.is_validated = True

    def set_active_channels(self, active: list[int] | None) -> None:
        """Restrict the composite to a subset of channel indices."""
        self.channels = list(active) if active is not None else None

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """[H, W, N] multichannel → [H, W, 3] uint8 RGB composite."""
        n = image.shape[2]
        if n < 5:
            return image  # already RGB(A)
        if self.colors is None:
            self.generate_colors(n)
        if not self.is_validated:
            self.validate(n)
        if image.dtype == np.uint16:
            image = (image >> 8).astype(np.uint8)
        sel = self.channels
        # gain folds into the weight matrix: one fused (H*W, k) @ (k, 3)
        weights = self.colors[sel, :] * np.float32(self.enhance)
        flat = image[:, :, sel].reshape(-1, len(sel)).astype(np.float32)
        rgb = (flat @ weights).reshape(*image.shape[:2], 3)
        return np.clip(rgb, 0, 255).astype(np.uint8)
