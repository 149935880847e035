"""Batch-axis data parallelism over local devices (counterpart of ``tiatoolbox_tpu/parallel/mesh.py``).

JAX shards the batch axis of every engine forward over a 1-D "data" mesh
of all local devices and lets XLA place the shards. Here a mesh is a list
of CUDA devices: the model keeps one replica on each
(``shard_model_variables``), a batch is cut into one chunk a device
(``shard_batch``), each replica runs its chunk on a stream of its own, and
the outputs are gathered in batch order on the first device
(``ModelABC.enable_data_parallel``). Upstream TIAToolbox reaches the same
with ``torch.nn.DataParallel`` on a multi-GPU host.

``local_devices`` is the one place where devices are listed, as
``jax.devices()`` is in JAX: ``cuda:0`` to ``cuda:n-1``. Without a card it
raises; it never falls back to the CPU. Tests replace it with a list of
repeated devices, as JAX's tests run on 8 virtual CPU devices.

Multi-process: ``initialize_multihost`` starts ``torch.distributed`` (NCCL)
where the arguments or torch's environment (``WORLD_SIZE > 1``,
``MASTER_ADDR``) say there are several processes; then each process feeds
its local chunk of the global batch to its local mesh
(``shard_batch_multihost``), and ``get_hybrid_data_mesh`` orders the global
batch axis process-major. Only the single-process behaviour is tested.

JAX's ``batch_sharding`` and ``replicated_sharding`` return
``jax.sharding`` objects and have no counterpart: the mesh's replicas and
chunks are what they describe.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh of devices along the batch axis "data".

    ``process_index`` and ``process_count`` place this process's devices
    on the global batch axis of a multi-process mesh (0 and 1 otherwise).
    """

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)
    process_index: int = 0
    process_count: int = 1
    # each card's side stream for the copies of ``shard_batch``, made at first use
    _copy_streams: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def size(self) -> int:
        """Devices of this process's mesh."""
        return len(self.devices)

    def copy_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The side stream ``shard_batch`` copies to ``device`` on."""
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)
        return stream


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process: ``cuda:0`` to ``cuda:n-1``.

    Raises:
        RuntimeError: no CUDA device is available.
    """
    if not torch.cuda.is_available():
        msg = "A data mesh needs CUDA devices and none is available."
        raise RuntimeError(msg)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_data_mesh(n_devices: int | None = None) -> DataMesh:
    """1-D mesh over the first ``n_devices`` local devices, axis "data" (JAX :19-25)."""
    devices = list(local_devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        msg = f"A data mesh needs at least one device, got n_devices={n_devices}."
        raise ValueError(msg)
    return DataMesh(tuple(devices))


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad axis 0 so its length divides ``multiple``; return (padded, n_valid) (JAX :38)."""
    n = batch.shape[0]
    remainder = n % multiple
    if remainder == 0:
        return batch, n
    pad = multiple - remainder
    pad_block = np.repeat(batch[-1:], pad, axis=0)
    return np.concatenate([batch, pad_block], axis=0), n


def shard_batch(batch, mesh: DataMesh | None = None) -> list[torch.Tensor]:
    """One chunk of axis 0 on each mesh device, in order (JAX :49).

    A host batch (numpy or a CPU tensor) is copied chunk by chunk from pinned
    memory, each on its device's side stream, and the device's current
    stream waits for its copy: the caller does not. A CUDA tensor's chunks
    are copied device to device the same way (a chunk already on its device
    is a view). Axis 0 must divide the mesh's size (``pad_to_multiple``).
    """
    if mesh is None:
        mesh = get_data_mesh()
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if batch.shape[0] % mesh.size:
        msg = f"A batch of {batch.shape[0]} does not split over {mesh.size} devices; pad it first."
        raise ValueError(msg)
    if batch.device.type == "cpu" and any(d.type == "cuda" for d in mesh.devices) and not batch.is_pinned():
        batch = batch.pin_memory()
    chunks = []
    for device, chunk in zip(mesh.devices, batch.chunk(mesh.size)):
        if chunk.device == device or device.type != "cuda":
            chunks.append(chunk.to(device))
            continue
        current = torch.cuda.current_stream(device)
        stream = mesh.copy_stream(device)
        if chunk.device.type == "cuda":
            stream.wait_stream(torch.cuda.current_stream(chunk.device))
        with torch.cuda.stream(stream):
            out = chunk.to(device, non_blocking=True)
        if chunk.device.type == "cuda":
            chunk.record_stream(stream)
        current.wait_stream(stream)
        out.record_stream(current)
        chunks.append(out)
    return chunks


def shard_model_variables(module: torch.nn.Module, mesh: DataMesh | None = None) -> list[torch.nn.Module]:
    """One replica of ``module`` on each mesh device, in eval mode and
    ``channels_last``, with its parameters' dtype (JAX :62).

    The replicas are deep copies; ``sync_replicas`` copies later weight
    changes into them.
    """
    if mesh is None:
        mesh = get_data_mesh()
    replicas = []
    for device in mesh.devices:
        replica = copy.deepcopy(module)
        replica.to(device, memory_format=torch.channels_last)
        replica.eval()
        replicas.append(replica)
    return replicas


def _version(t: torch.Tensor) -> int:
    try:
        return t._version
    except RuntimeError:  # an inference tensor keeps no version, and cannot be written to outside inference mode
        return -1


def state_signature(module: torch.nn.Module) -> tuple:
    """Where and at which version each parameter and buffer is: it changes
    when weights are loaded, cast or moved."""
    return tuple((t.data_ptr(), _version(t), t.dtype) for t in (*module.parameters(), *module.buffers()))


@torch.no_grad()
def sync_replicas(module: torch.nn.Module, replicas: list[torch.nn.Module]) -> None:
    """Copy ``module``'s parameters and buffers into each replica, on the
    replica's device; dtypes must match (``shard_model_variables`` again
    where they do not)."""
    source = [*module.parameters(), *module.buffers()]
    for replica in replicas:
        for dst, src in zip([*replica.parameters(), *replica.buffers()], source):
            dst.copy_(src)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Start ``torch.distributed`` (NCCL) for a multi-process run (JAX :79-116).

    Call once per process before any collective. With no arguments it
    decides from torch's environment (``WORLD_SIZE`` above 1, or
    ``MASTER_ADDR``) without touching the backend, and returns False when
    this is a single process. ``coordinator_address`` is ``host:port`` or a
    ``tcp://`` URL; without one, ``env://`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT``.
    """
    if coordinator_address is None and num_processes is None and process_id is None:
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if world <= 1 and not os.environ.get("MASTER_ADDR"):
            return False
    import torch.distributed as dist

    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group("nccl", init_method=init_method, **kwargs)
    return True


def _process_count() -> tuple[int, int]:
    """(this process's rank, the number of processes) of ``torch.distributed``, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def get_hybrid_data_mesh(n_devices: int | None = None) -> DataMesh:
    """The "data" mesh of a multi-process run, process-major (JAX :119-144).

    With one process it equals ``get_data_mesh``. With several, each process
    holds its local devices, and the global batch axis is its processes'
    chunks in rank order: per-process chunks never cross between hosts.
    """
    rank, count = _process_count()
    if count <= 1:
        return get_data_mesh(n_devices)
    if n_devices is not None:
        # a truncated multi-process mesh would leave some processes' chunks without a device
        msg = "n_devices cannot be used with a multi-host mesh."
        raise ValueError(msg)
    return DataMesh(tuple(local_devices()), process_index=rank, process_count=count)


def shard_batch_multihost(local_batch, mesh: DataMesh | None = None) -> list[torch.Tensor]:
    """This process's chunk of the global batch on its local mesh (JAX :147-161).

    Each process reads and stages only its own patches (its rank's
    ``1 / process_count`` of the global batch); with one process this is
    ``shard_batch``.
    """
    if mesh is None:
        mesh = get_hybrid_data_mesh()
    return shard_batch(local_batch, mesh)
