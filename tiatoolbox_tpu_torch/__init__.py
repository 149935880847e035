"""tiatoolbox_tpu_torch: the PyTorch/CUDA port of ``tiatoolbox_tpu``.

The package mirrors ``tiatoolbox_tpu``'s module paths. It imports only
``torch``, ``numpy``, ``scipy`` and the standard library. Entry points run
on ``rcParam["device"]`` (``"cuda"`` by default) unless the caller passes
``device="cpu"``; asking for ``cuda`` where there is none raises.

This module holds the runtime configuration (``rcParam``), the package
logger with its duplicate filter (``tiatoolbox_tpu/__init__.py:37-80``) and
the pretrained-model registry entries the port serves
(``tiatoolbox_tpu/data/pretrained_model.yaml``), carried as a dict.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import torch

__version__ = "0.1.0"


class DuplicateFilter(logging.Filter):
    """Suppress a log message that repeats the one just before it."""

    def filter(self, record: logging.LogRecord) -> bool:
        """Return True unless the record repeats the previous one."""
        current_log = (record.module, record.levelno, record.getMessage())
        last_log = getattr(self, "last_log", None)
        if current_log != last_log:
            self.last_log = current_log
            return True
        return False


def _configure_logger() -> logging.Logger:
    """The package logger: INFO and below to stdout, WARNING and up to stderr."""
    lgr = logging.getLogger("tiatoolbox_tpu_torch")
    if lgr.handlers:
        return lgr
    formatter = logging.Formatter(
        "|%(asctime)s.%(msecs)03d| [%(levelname)s] %(message)s",
        datefmt="%Y-%m-%d|%H:%M:%S",
    )
    out = logging.StreamHandler(sys.stdout)
    out.setFormatter(formatter)
    out.addFilter(lambda r: r.levelno <= logging.INFO)
    err = logging.StreamHandler(sys.stderr)
    err.setFormatter(formatter)
    err.setLevel(logging.WARNING)
    lgr.addHandler(out)
    lgr.addHandler(err)
    lgr.setLevel(logging.INFO)
    lgr.propagate = False
    return lgr


logger = _configure_logger()


def _default_home() -> Path:
    env = os.environ.get("TIATOOLBOX_TPU_HOME")
    if env:
        return Path(env)
    return Path.home() / ".tiatoolbox_tpu"


rcParam: dict = {
    "TIATOOLBOX_HOME": _default_home(),
    "device": "cuda",
    "compute_dtype": torch.float32,
}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` or ``rcParam["device"]``.

    Raises:
        RuntimeError: a CUDA device is asked for and none is available.
    """
    dev = torch.device(rcParam["device"] if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = (
            f"Device {dev} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU."
        )
        raise RuntimeError(msg)
    return dev


# Entries of ``tiatoolbox_tpu/data/pretrained_model.yaml``, copied by hand.
PRETRAINED_MODELS: dict = {
    "resnet18-kather100k": {
        "architecture": {
            "class": "vanilla.CNNModel",
            "kwargs": {"backbone": "resnet18", "num_classes": 9},
        },
        "dataset": "kather100k",
        "ioconfig": {
            "class": "IOPatchPredictorConfig",
            "kwargs": {
                "input_resolutions": [{"resolution": 0.5, "units": "mpp"}],
                "patch_input_shape": [224, 224],
                "stride_shape": [224, 224],
            },
        },
    },
    "fcn-tissue_mask": {
        "architecture": {
            "class": "unet.UNetModel",
            "kwargs": {
                "decoder_block": [3],
                "encoder": "resnet50",
                "num_input_channels": 3,
                "num_output_channels": 2,
            },
        },
        "ioconfig": {
            "class": "IOSegmentorConfig",
            "kwargs": {
                "ignore_index": 0,
                "input_resolutions": [{"resolution": 2.0, "units": "mpp"}],
                "output_resolutions": [{"resolution": 2.0, "units": "mpp"}],
                "patch_input_shape": [1024, 1024],
                "patch_output_shape": [512, 512],
                "save_resolution": {"resolution": 8.0, "units": "mpp"},
                "stride_shape": [450, 450],
            },
        },
    },
    "fcn_resnet50_unet-bcss": {
        "architecture": {
            "class": "unet.UNetModel",
            "kwargs": {
                "decoder_block": [3, 3],
                "encoder": "resnet50",
                "num_input_channels": 3,
                "num_output_channels": 5,
            },
        },
        "ioconfig": {
            "class": "IOSegmentorConfig",
            "kwargs": {
                "ignore_index": 0,
                "input_resolutions": [{"resolution": 0.25, "units": "mpp"}],
                "output_resolutions": [{"resolution": 0.25, "units": "mpp"}],
                "patch_input_shape": [1024, 1024],
                "patch_output_shape": [512, 512],
                "save_resolution": {"resolution": 0.25, "units": "mpp"},
                "stride_shape": [450, 450],
            },
        },
    },
}

_HOVERNET_RESOLUTION = {"resolution": 0.25, "units": "mpp"}


def _hovernet_entry(
    mode: str, num_types, nuc_type_dict, patch: int, out: int, tile: int, *, ignore_index: bool = True
) -> dict:
    """A ``hovernet.HoVerNet`` registry entry (``pretrained_model.yaml:666-829``)."""
    kwargs = {
        "input_resolutions": [dict(_HOVERNET_RESOLUTION)],
        "margin": 128,
        "output_resolutions": [dict(_HOVERNET_RESOLUTION) for _ in range(3 if num_types else 2)],
        "patch_input_shape": [patch, patch],
        "patch_output_shape": [out, out],
        "save_resolution": dict(_HOVERNET_RESOLUTION),
        "stride_shape": [out, out],
        "tile_shape": [tile, tile],
    }
    if ignore_index:
        kwargs["ignore_index"] = 0
    arch = {"mode": mode, "num_types": num_types}
    if nuc_type_dict is not None:
        arch["nuc_type_dict"] = nuc_type_dict
    return {
        "architecture": {"class": "hovernet.HoVerNet", "kwargs": arch},
        "ioconfig": {"class": "IOInstanceSegmentorConfig", "kwargs": kwargs},
    }


PRETRAINED_MODELS.update(
    {
        "hovernet_fast-monusac": _hovernet_entry(
            "fast",
            5,
            {0: "Background", 1: "Epithelial", 2: "Lymphocyte", 3: "Macrophage", 4: "Neutrophil"},
            256,
            164,
            1024,
        ),
        "hovernet_fast-pannuke": _hovernet_entry(
            "fast",
            6,
            {
                0: "Background",
                1: "Neoplastic",
                2: "Inflammatory",
                3: "Connective",
                4: "Dead",
                5: "Non-Neoplastic Epithelial",
            },
            256,
            164,
            1024,
        ),
        "hovernet_original-consep": _hovernet_entry(
            "original",
            5,
            {0: "Background", 1: "Epithelial", 2: "Inflammatory", 3: "Spindle-Shaped", 4: "Miscellaneous"},
            270,
            80,
            1024,
            ignore_index=False,
        ),
        "hovernet_original-kumar": _hovernet_entry("original", None, None, 270, 80, 2048),
    }
)
