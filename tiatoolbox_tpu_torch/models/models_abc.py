"""Model abstraction for the inference engines (counterpart of ``tiatoolbox_tpu/models/models_abc.py``).

``ModelABC`` (:22) is an ``nn.Module`` here: its parameters live on the
module, ``forward`` takes an NHWC float batch, and the engine-facing
methods keep the JAX names:

- ``stage_batch`` (:268) copies a host uint8 batch to the model's device,
  from pinned memory on a side stream, without waiting for the copy;
- ``apply_u8`` (:229, RGB branch) casts uint8 to the compute dtype,
  divides by 255 and runs ``forward``;
- ``infer_batch`` (:349) returns host numpy outputs, ``infer_batch_device``
  the device tensor without a synchronisation. A ``device`` given to either
  moves the model there first (through ``resolve_device``, which raises
  where CUDA is asked for and absent); without one the model runs where
  its parameters are;
- ``place`` puts a built model on its device and, for a compute dtype
  other than float32, casts its floating parameters and buffers to that
  dtype, as ``optimize_for_inference`` (:171-190) casts the flax variables,
  so the forward runs in that dtype (weights loaded later are copied into
  the cast parameters);
- ``postproc_func`` (:330) is the host post-processing the engines apply
  to the model's outputs: ``postproc`` (the identity) unless the caller
  sets one.

``load_torch_model`` (:386) loads a ``.pth`` ``state_dict`` (or a flax
``.npz``, through the converter) into a model, and ``model_to`` (:396)
moves it to a device; JAX's is a no-op, as JAX places arrays itself.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from tiatoolbox_tpu_torch import rcParam, resolve_device


class ModelABC(nn.Module):
    """Base inference model: an ``nn.Module`` with a host preprocessing hook.

    Args:
        compute_dtype: dtype a uint8 batch is cast to before ``forward``
            (``rcParam["compute_dtype"]`` by default).
    """

    def __init__(self, compute_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype or rcParam["compute_dtype"]
        self._preproc_func: Callable | None = None
        self._postproc_func: Callable | None = None
        self._transfer_streams: dict[torch.device, torch.cuda.Stream] = {}

    def place(self, device: str | torch.device | None = None) -> None:
        """Move to ``resolve_device(device)`` in channels_last, cast to the
        compute dtype unless it is float32, and switch to eval mode."""
        self.to(resolve_device(device), memory_format=torch.channels_last)
        if self.compute_dtype != torch.float32:
            self.to(self.compute_dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        """The device of the model's parameters."""
        return next(self.parameters()).device

    def forward(self, batch: torch.Tensor):
        """NHWC float batch -> network output."""
        raise NotImplementedError

    def stage_batch(self, batch) -> torch.Tensor:
        """Copy a host batch to the model's device; a device tensor passes through.

        On a CUDA device the copy runs from pinned memory on a side stream;
        the current stream waits for it, so the caller does not.
        """
        dev = self.device
        if isinstance(batch, torch.Tensor) and batch.device == dev:
            return batch
        host = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(batch)
        )
        if dev.type != "cuda":
            return host.to(dev)
        if not host.is_pinned():
            host = host.pin_memory()
        stream = self._transfer_streams.get(dev)
        if stream is None:
            stream = self._transfer_streams[dev] = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        with torch.cuda.stream(stream):
            out = host.to(dev, non_blocking=True)
        current.wait_stream(stream)
        out.record_stream(current)
        return out

    @torch.inference_mode()
    def apply_u8(self, batch: torch.Tensor):
        """uint8 NHWC batch -> compute dtype -> /255 -> ``forward``.

        A floating batch is taken as model-ready (a host preproc already
        scaled it) and only cast.
        """
        if batch.is_floating_point():
            return self(batch.to(self.compute_dtype))
        return self(batch.to(self.compute_dtype).div_(255.0))

    @property
    def preproc_func(self) -> Callable:
        """Per-patch host preprocessing (the model's ``preproc`` by default)."""
        return self._preproc_func if self._preproc_func is not None else self.preproc

    @preproc_func.setter
    def preproc_func(self, func: Callable | None) -> None:
        self._preproc_func = func

    @property
    def postproc_func(self) -> Callable:
        """Host post-processing of the outputs (the model's ``postproc`` by default)."""
        return self._postproc_func if self._postproc_func is not None else self.postproc

    @postproc_func.setter
    def postproc_func(self, func: Callable | None) -> None:
        self._postproc_func = func

    @staticmethod
    def preproc(image: np.ndarray) -> np.ndarray:
        """Default per-patch preprocessing: identity."""
        return image

    @staticmethod
    def postproc(output):
        """Default output post-processing: identity."""
        return output

    @classmethod
    def infer_batch_device(cls, model: "ModelABC", batch_data, device=None):
        """Forward a uint8 NHWC batch; return the device output without syncing."""
        if device is not None:
            model.to(resolve_device(device))
        return model.apply_u8(model.stage_batch(batch_data))

    @classmethod
    def infer_batch(cls, model: "ModelABC", batch_data, device=None) -> np.ndarray:
        """Forward a uint8 NHWC batch and return the output as numpy."""
        return cls.infer_batch_device(model, batch_data, device).cpu().numpy()


def load_torch_model(model: ModelABC, weights) -> ModelABC:
    """Load a checkpoint into ``model`` and return it (JAX ``models_abc.py:386-393``).

    ``weights`` is a torch ``state_dict`` file (``.pth``, strict, as upstream's
    ``torch.load`` + ``load_state_dict``) or a flax ``.npz``, which goes through
    the port's converter.
    """
    from tiatoolbox_tpu_torch.models.architecture import load_weights

    load_weights(model, weights)
    return model


def model_to(model: ModelABC, device: str | torch.device | None = None) -> ModelABC:
    """Move ``model`` to ``device`` (``rcParam["device"]`` by default) and return it
    (JAX ``models_abc.py:396-403``).

    Raises:
        RuntimeError: CUDA is asked for and absent (``resolve_device``).
    """
    return model.to(resolve_device(device))
