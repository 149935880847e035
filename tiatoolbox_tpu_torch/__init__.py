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


# The ``resnet18-kather100k`` entry of ``tiatoolbox_tpu/data/pretrained_model.yaml``.
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
}
