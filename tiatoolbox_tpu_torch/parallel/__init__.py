"""Host batch loading of the port."""

from tiatoolbox_tpu_torch.parallel.pipeline import BatchLoader

__all__ = ["BatchLoader"]
