"""Model abstraction for the inference engines (counterpart of ``tiatoolbox_tpu/models/models_abc.py``).

``ModelABC`` (:22) is an ``nn.Module`` here: its parameters live on the
module, ``forward`` takes an NHWC float batch, and the engine-facing
methods keep the JAX names:

- ``stage_batch`` (:268) copies a host uint8 batch to the model's device,
  from pinned memory on a side stream, without waiting for the copy; with
  ``wire_format="yuv420"`` (:54-66) a 4-D uint8 host batch is first packed
  into full-range BT.601 4:2:0 planes (``pack_wire``, :296-303: half the
  bytes), never a 3-D band;
- ``apply_u8`` (:229) casts uint8 to the compute dtype, divides by 255 and
  runs ``forward``; a 3-D uint8 batch is packed planes, unpacked into the
  compute dtype and divided by 255 in one pass of kernel K8 (:245-257);
- ``enable_data_parallel`` (:105-121) splits every forward's batch axis over
  a mesh of devices (``parallel/mesh.py``): one replica a device, each
  running its chunk on a stream of its own, the outputs gathered in batch
  order on the first device, where the model itself stays; ``shard_batch``
  (:123-135) places a padded host batch chunk by chunk;
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

``wire_format="auto"`` resolves to ``"rgb"``: JAX probes a TPU relay link
for it (``parallel/pipeline.py:27-91``), which one local card does not
have. ``load_torch_model`` (:386) loads a ``.pth`` ``state_dict`` (or a flax
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
        # "rgb" ships raw uint8 NHWC; "yuv420" packed 4:2:0 planes, 1.5 bytes a pixel
        self.wire_format = "rgb"
        self.mesh = None  # set by enable_data_parallel()

    def __getstate__(self) -> dict:
        """The module's state without its streams and data-parallel replicas
        (a copy, a replica included, makes its own)."""
        state = dict(super().__getstate__())
        state.update(_transfer_streams={}, _mesh=None, _replicas=[], _replica_streams=[],
                     _replica_signature=None)
        return state

    # -- the wire ----------------------------------------------------------------

    @property
    def resolved_wire_format(self) -> str:
        """The wire a host batch takes: "yuv420" where asked for, else "rgb"
        ("auto" included: the link probe behind it is TPU-only)."""
        return "yuv420" if self.wire_format == "yuv420" else "rgb"

    @staticmethod
    def pack_wire(batch, *, pin_memory: bool = False) -> torch.Tensor:
        """Pack a uint8 RGB ``[B, H, W, 3]`` host batch into ``[B, 1.5 H, W]``
        planes, written straight into a pinned buffer where ``pin_memory``."""
        from tiatoolbox_tpu_torch.ops.colorconv import rgb_batch_to_yuv420

        arr = batch.numpy() if isinstance(batch, torch.Tensor) else np.asarray(batch)
        n, h, w, _ = arr.shape
        out = torch.empty((n, h + h // 2, w), dtype=torch.uint8, pin_memory=pin_memory)
        rgb_batch_to_yuv420(arr, out=out.numpy())
        return out

    # -- data parallelism -----------------------------------------------------------

    @property
    def mesh(self):
        """The data mesh forwards are split over, or None (one device)."""
        return self._mesh

    @mesh.setter
    def mesh(self, value) -> None:
        self._mesh = value
        if value is None:
            self._replicas, self._replica_streams, self._replica_signature = [], [], None

    def enable_data_parallel(self, n_devices: int | None = None) -> "ModelABC":
        """Split the batch axis of every forward over the local device mesh.

        Moves the model to the mesh's first device and makes one replica on
        each mesh device (outside the module registry, so ``state_dict()``
        keeps its names); weights changed later reach the replicas before
        the next forward.
        """
        from tiatoolbox_tpu_torch.parallel.mesh import get_data_mesh

        mesh = get_data_mesh(n_devices)
        self.to(mesh.devices[0])
        self.mesh = mesh
        self._sync_replicas()
        return self

    def _sync_replicas(self) -> list:
        """The replicas, made or brought up to date with this module's weights."""
        from tiatoolbox_tpu_torch.parallel.mesh import shard_model_variables, state_signature, sync_replicas

        signature = state_signature(self)
        if signature != self._replica_signature:
            same_types = self._replicas and all(
                a.dtype == b.dtype for a, b in zip(self._replicas[0].parameters(), self.parameters())
            )
            if same_types:
                sync_replicas(self, self._replicas)
            else:
                self._replicas = shard_model_variables(self, self.mesh)
                self._replica_streams = []
            self._replica_signature = signature
        return self._replicas

    def shard_batch(self, batch):
        """A host batch padded to the mesh size and placed chunk by chunk on
        its devices (a list, one chunk a device); the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        from tiatoolbox_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch

        arr = batch.numpy() if isinstance(batch, torch.Tensor) else np.asarray(batch)
        padded, _ = pad_to_multiple(arr, self.mesh.size)
        return shard_batch(padded, self.mesh)

    def __call__(self, *args, **kwargs):
        """``forward``, split over the mesh's replicas where there is a mesh."""
        if self.mesh is None or kwargs or len(args) != 1:
            return super().__call__(*args, **kwargs)
        return self._forward_data_parallel(args[0])

    def _forward_data_parallel(self, batch: torch.Tensor):
        """Pad the batch to the mesh size, run one chunk on each replica (each
        on a stream of its own on a card), and gather the outputs in batch
        order on the batch's device, cut back to the batch."""
        from tiatoolbox_tpu_torch.parallel.mesh import shard_batch

        replicas = self._sync_replicas()
        n = batch.shape[0]
        pad = (-n) % len(replicas)
        if pad:
            batch = torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])
        chunks = shard_batch(batch, self.mesh)
        home = batch.device
        if home.type != "cuda":
            return _gather([replica(chunk) for replica, chunk in zip(replicas, chunks)], n)
        while len(self._replica_streams) < len(replicas):
            device = self.mesh.devices[len(self._replica_streams)]
            self._replica_streams.append(torch.cuda.Stream(device))
        current = torch.cuda.current_stream(home)
        outs = []
        for replica, chunk, stream in zip(replicas, chunks, self._replica_streams):
            stream.wait_stream(torch.cuda.current_stream(chunk.device))
            with torch.cuda.stream(stream):
                out = _to_device(replica(chunk), home)
            chunk.record_stream(stream)
            _record(out, current)
            outs.append(out)
        for stream in self._replica_streams[: len(replicas)]:
            current.wait_stream(stream)
        return _gather(outs, n)

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
        if (
            self.resolved_wire_format == "yuv420"
            and getattr(batch, "ndim", 0) == 4
            and batch.dtype in (np.uint8, torch.uint8)
        ):
            batch = self.pack_wire(batch, pin_memory=dev.type == "cuda")
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
        scaled it) and only cast. A 3-D uint8 batch is packed yuv420 planes:
        K8 unpacks them into the compute dtype, divided by 255, in one pass.
        """
        if batch.is_floating_point():
            return self(batch.to(self.compute_dtype))
        if batch.ndim == 3:
            from tiatoolbox_tpu_torch.ops.colorconv import yuv420_batch_to_rgb

            return self(yuv420_batch_to_rgb(batch, self.compute_dtype, scale=True))
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


def _to_device(out, device: torch.device):
    """A forward's output (a tensor, or a dict, tuple or list of them) on ``device``."""
    if isinstance(out, torch.Tensor):
        return out.to(device, non_blocking=True)
    if isinstance(out, dict):
        return {k: _to_device(v, device) for k, v in out.items()}
    return type(out)(_to_device(v, device) for v in out)


def _record(out, stream) -> None:
    """Mark every tensor of ``out`` as used on ``stream``."""
    if isinstance(out, torch.Tensor):
        out.record_stream(stream)
    else:
        for v in out.values() if isinstance(out, dict) else out:
            _record(v, stream)


def _gather(outs: list, n: int):
    """The replicas' outputs, on one device, concatenated along the batch axis: the first ``n`` rows."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)[:n]
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], n) for k in first}
    return type(first)(_gather([o[i] for o in outs], n) for i in range(len(first)))


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
