"""WSI I/O core: metadata, readers, and the tiling contract (counterpart of
``tiatoolbox_tpu/wsicore/__init__.py``, whose ``WSIReaderParams`` is copied)."""

from __future__ import annotations

from numbers import Number
from typing import TypedDict

from tiatoolbox_tpu_torch.wsicore.wsimeta import WSIMeta


class WSIReaderParams(TypedDict, total=False):
    """Parameters for reading whole slide images (JAX ``wsicore/__init__.py:11-17``)."""

    meta: WSIMeta | None
    mpp: tuple[Number, Number] | Number
    power: Number
