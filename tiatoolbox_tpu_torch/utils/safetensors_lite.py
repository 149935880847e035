"""A reader and writer of the ``.safetensors`` format, and ``pytorch_model.bin``.

The format (``huggingface/safetensors``, ``docs/source/index.mdx``): an
8-byte little-endian header length N, N bytes of JSON mapping each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
buffer that follows the header; an optional ``"__metadata__"`` entry of
strings), then the buffers, little endian and row major. The port reads
F32, F16, BF16 and I64 buffers, what transformers' checkpoints hold; any
other dtype raises and names itself. The writer takes F32 only, what
``SamModel.save_pretrained`` writes. ``pytorch_model.bin``, the older
checkpoint file, is read with ``torch.load(weights_only=True)``.

No module of ``safetensors`` is imported: the port runs where it is not
installed.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

# safetensors dtype -> (little-endian numpy dtype of the buffer, torch dtype)
_DTYPES = {
    "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16),
    "BF16": ("<u2", torch.bfloat16),
    "I64": ("<i8", torch.int64),
}


def _read_header(path: str | Path) -> tuple[dict, int]:
    """The JSON header of a ``.safetensors`` file and the offset of its buffers."""
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) != 8:
            msg = f"{path}: not a safetensors file (shorter than its 8-byte header length)."
            raise ValueError(msg)
        (n,) = struct.unpack("<Q", head)
        raw = fh.read(n)
    if len(raw) != n:
        msg = f"{path}: the header says {n} bytes, the file holds {len(raw)}."
        raise ValueError(msg)
    return json.loads(raw), 8 + n


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in file order.

    Raises:
        ValueError: a dtype other than F32, F16, BF16 and I64, or offsets
            that do not match the shape.
    """
    header, base = _read_header(path)
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as fh:
        for name, info in header.items():
            if name == "__metadata__":
                continue
            kind = info["dtype"]
            if kind not in _DTYPES:
                msg = f"{path}: tensor {name!r} has dtype {kind}; the reader takes {sorted(_DTYPES)}."
                raise ValueError(msg)
            np_dtype, torch_dtype = _DTYPES[kind]
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * np.dtype(np_dtype).itemsize:
                msg = f"{path}: tensor {name!r} of shape {shape} spans {end - begin} bytes."
                raise ValueError(msg)
            array = np.empty(count, np.dtype(np_dtype).newbyteorder("="))
            fh.seek(base + begin)
            if count and fh.readinto(memoryview(array).cast("B")) != end - begin:
                msg = f"{path}: tensor {name!r} is cut short."
                raise ValueError(msg)
            tensor = torch.from_numpy(array.reshape(shape))
            out[name] = tensor.view(torch.bfloat16) if torch_dtype == torch.bfloat16 else tensor
    return out


def save_safetensors(tensors: dict[str, np.ndarray], path: str | Path) -> Path:
    """Write float32 numpy arrays (what ``SamModel.save_pretrained`` writes)
    as a ``.safetensors`` file."""
    header: dict = {"__metadata__": {"format": "pt"}}
    arrays, offset = [], 0
    for name, value in tensors.items():
        array = np.ascontiguousarray(value)
        if array.dtype != np.float32:
            msg = f"tensor {name!r} has dtype {array.dtype}; the writer takes float32."
            raise ValueError(msg)
        array = array.astype("<f4", copy=False)
        header[name] = {
            "dtype": "F32",
            "shape": list(array.shape),
            "data_offsets": [offset, offset + array.nbytes],
        }
        arrays.append(array)
        offset += array.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the buffers start 8-byte aligned
    path = Path(path)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for array in arrays:
            fh.write(array.tobytes())
    return path


def load_checkpoint_file(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file, or a ``pytorch_model.bin`` read with
    ``torch.load(weights_only=True)``, as a name -> CPU tensor mapping."""
    path = Path(path)
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    return dict(torch.load(path, map_location="cpu", weights_only=True))
