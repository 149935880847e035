"""Batch data parallelism over local devices and host batch loading of the port
(counterpart of ``tiatoolbox_tpu/parallel/__init__.py``, its exports at :9-17)."""

from tiatoolbox_tpu_torch.parallel.mesh import (
    get_data_mesh,
    get_hybrid_data_mesh,
    initialize_multihost,
    pad_to_multiple,
    shard_batch,
    shard_batch_multihost,
)
from tiatoolbox_tpu_torch.parallel.pipeline import BatchLoader

__all__ = [
    "BatchLoader",
    "get_data_mesh",
    "get_hybrid_data_mesh",
    "initialize_multihost",
    "pad_to_multiple",
    "shard_batch",
    "shard_batch_multihost",
]
