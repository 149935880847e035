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


def _classifier_entry(backbone: str, num_classes: int, dataset: str, mpp: float, patch: int) -> dict:
    """A ``vanilla.CNNModel`` registry entry (``pretrained_model.yaml:1-665``)."""
    return {
        "architecture": {"class": "vanilla.CNNModel", "kwargs": {"backbone": backbone, "num_classes": num_classes}},
        "dataset": dataset,
        "ioconfig": {
            "class": "IOPatchPredictorConfig",
            "kwargs": {
                "input_resolutions": [{"resolution": mpp, "units": "mpp"}],
                "patch_input_shape": [patch, patch],
                "stride_shape": [patch, patch],
            },
        },
    }


# the registry's 19 classifier backbones, each trained on kather100k (9
# classes, 224^2 at 0.5 mpp) and on pcam (2 classes, 96^2 at 1.0 mpp)
_CLASSIFIER_BACKBONES = (
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201", "googlenet", "inception_v3",
    "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small", "resnet18", "resnet34", "resnet50",
    "resnet101", "resnet152", "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2", "wide_resnet101_2",
)
_IDARS_TARGETS = ("braf", "cimp", "cin", "hm", "msi", "tp53")

# Entries of ``tiatoolbox_tpu/data/pretrained_model.yaml``, carried as a dict.
PRETRAINED_MODELS: dict = {
    **{f"{b}-kather100k": _classifier_entry(b, 9, "kather100k", 0.5, 224) for b in _CLASSIFIER_BACKBONES},
    **{f"{b}-pcam": _classifier_entry(b, 2, "pcam", 1.0, 96) for b in _CLASSIFIER_BACKBONES},
    # IDaRS (Bilal et al.): resnet18 at 0.5 mpp (its tumour model at 512^2),
    # resnet34 at 1 mpp
    **{f"resnet18-idars-{t}": _classifier_entry("resnet18", 2, "idars", 0.5, 224) for t in _IDARS_TARGETS},
    "resnet18-idars-tumour": _classifier_entry("resnet18", 2, "idars", 0.5, 512),
    **{f"resnet34-idars-{t}": _classifier_entry("resnet34", 2, "idars", 1, 224) for t in _IDARS_TARGETS},
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


def _segmentor_ioconfig(mpp: float, patch: int, out: int, stride: int, *, tile: int | None = 2048, **extra) -> dict:
    """An ``IOSegmentorConfig`` of one input and one output at ``mpp``."""
    res = {"resolution": mpp, "units": "mpp"}
    kwargs = {
        **extra,
        "input_resolutions": [dict(res)],
        "output_resolutions": [dict(res)],
        "patch_input_shape": [patch, patch],
        "patch_output_shape": [out, out],
        "save_resolution": dict(res),
        "stride_shape": [stride, stride],
    }
    if tile is not None:
        kwargs["tile_shape"] = [tile, tile]
    return {"class": "IOSegmentorConfig", "kwargs": kwargs}


def _detector_entry(cls: str, ioconfig: dict, **arch) -> dict:
    """A MapDe or SCCNN registry entry: one nucleus class."""
    kwargs = {"class_dict": {0: "nucleus"}, **arch, "tile_shape": [2048, 2048]}
    return {"architecture": {"class": cls, "kwargs": kwargs}, "ioconfig": ioconfig}


# ``pretrained_model.yaml:830`` (hovernetplus-oed), :919 and :954 (mapde-*),
# :992 (micronet-consep), :1746 and :1784 (sccnn-*)
PRETRAINED_MODELS.update(
    {
        "hovernetplus-oed": {
            "architecture": {
                "class": "hovernetplus.HoVerNetPlus",
                "kwargs": {
                    "layer_type_dict": {
                        0: "Background",
                        1: "Other Tissue",
                        2: "Basal Epithelium",
                        3: "(Core) Epithelium",
                        4: "Keratin",
                    },
                    "nuc_type_dict": {0: "Background", 1: "Other", 2: "Epithelial"},
                    "num_layers": 5,
                    "num_types": 3,
                },
            },
            "ioconfig": {
                "class": "IOInstanceSegmentorConfig",
                "kwargs": {
                    "ignore_index": 0,
                    "input_resolutions": [{"resolution": 0.5, "units": "mpp"}],
                    "margin": 128,
                    "output_resolutions": [{"resolution": 0.5, "units": "mpp"} for _ in range(4)],
                    "patch_input_shape": [256, 256],
                    "patch_output_shape": [164, 164],
                    "save_resolution": {"resolution": 0.5, "units": "mpp"},
                    "stride_shape": [164, 164],
                    "tile_shape": [2048, 2048],
                },
            },
        },
        "mapde-conic": _detector_entry(
            "mapde.MapDe",
            _segmentor_ioconfig(0.5, 252, 252, 150, tile=None),
            min_distance=3, num_classes=1, num_input_channels=3, threshold_abs=205,
        ),
        "mapde-crchisto": _detector_entry(
            "mapde.MapDe",
            _segmentor_ioconfig(0.5, 252, 252, 150),
            min_distance=4, num_classes=1, num_input_channels=3, threshold_abs=250,
        ),
        "micronet-consep": {
            "architecture": {
                "class": "micronet.MicroNet",
                "kwargs": {"num_input_channels": 3, "num_output_channels": 2},
            },
            "ioconfig": _segmentor_ioconfig(0.25, 252, 252, 150, ignore_index=0),
        },
        "sccnn-conic": _detector_entry(
            "sccnn.SCCNN",
            _segmentor_ioconfig(0.25, 31, 13, 8, tile=None),
            min_distance=5, num_input_channels=3, patch_output_shape=[13, 13], radius=12, threshold_abs=0.05,
        ),
        "sccnn-crchisto": _detector_entry(
            "sccnn.SCCNN",
            _segmentor_ioconfig(0.25, 31, 13, 8, tile=None),
            min_distance=6, num_input_channels=3, patch_output_shape=[13, 13], radius=12, threshold_abs=0.2,
        ),
    }
)


def _kongnet_entry(
    class_dict: dict, min_distance: int, heads: int, targets: list, mpp: float, patch: int, stride: int,
    *, channels_per_head: int = 3, threshold: float = 0.5, wide: bool = False,
) -> dict:
    """A ``kongnet.KongNet`` registry entry (``pretrained_model.yaml:1-301``), saved at baseline."""
    ioconfig = _segmentor_ioconfig(mpp, patch, patch, stride, tile=None)
    ioconfig["kwargs"]["save_resolution"] = {"resolution": 1.0, "units": "baseline"}
    return {
        "architecture": {
            "class": "kongnet.KongNet",
            "kwargs": {
                "class_dict": class_dict,
                "min_distance": min_distance,
                "num_channels_per_head": [channels_per_head] * heads,
                "num_heads": heads,
                "target_channels": targets,
                "threshold_abs": threshold,
                "tile_shape": [2048, 2048],
                "wide_decoder": wide,
            },
        },
        "ioconfig": ioconfig,
    }


def _baseline_ioconfig(resolution: float, patch: int, out: int, stride: int | None, save: float) -> dict:
    """An ``IOSegmentorConfig`` in baseline units, ``ignore_index`` 0."""
    res = {"resolution": resolution, "units": "baseline"}
    kwargs = {
        "ignore_index": 0,
        "input_resolutions": [dict(res)],
        "output_resolutions": [dict(res)],
        "patch_input_shape": [patch, patch],
        "patch_output_shape": [out, out],
        "save_resolution": {"resolution": save, "units": "baseline"},
    }
    if stride is not None:
        kwargs["stride_shape"] = [stride, stride]
    return {"class": "IOSegmentorConfig", "kwargs": kwargs}


_PUMA_T2_CLASSES = (
    "Tumour_Cell", "Lymphocyte", "Plasma_Cell", "Histiocyte", "Melanophage", "Neutrophil", "Stroma_Cell",
    "Epithelial_Cell", "Endothelial_Cell", "Apoptotic_Cell",
)

# ``pretrained_model.yaml:1-301`` (KongNet), :502 (efficientunet-tissue_mask),
# :635 (grandqc_tissue_detection), :1144 and :1180 (nuclick_*) and :1822
# (unet_tissue_mask_tsef)
PRETRAINED_MODELS.update(
    {
        "KongNet_CoNIC_1": _kongnet_entry(
            dict(enumerate(("Neutrophil", "Epithelial", "Lymphocyte", "Plasma", "Eosinophil", "Connective"))),
            5, 6, [2, 5, 8, 11, 14, 17], 0.5, 256, 248,
        ),
        "KongNet_Det_MIDOG_1": _kongnet_entry(
            {0: "Mitotic_Figure"}, 21, 1, [0], 0.5, 512, 492, channels_per_head=1, threshold=0.99
        ),
        "KongNet_MONKEY_1": _kongnet_entry(
            dict(enumerate(("Overall_Inflammatory", "Lymphocyte", "Monocyte"))), 11, 3, [2, 5, 8], 0.25, 256, 224,
            wide=True,
        ),
        "KongNet_PUMA_T1_3": _kongnet_entry(
            dict(enumerate(("Tumour_Cell", "Lymphocyte", "Other_Cell"))), 13, 3, [2, 5, 8], 0.25, 256, 224
        ),
        "KongNet_PUMA_T2_3": _kongnet_entry(
            dict(enumerate(_PUMA_T2_CLASSES)), 13, 10, list(range(2, 30, 3)), 0.25, 256, 224
        ),
        "KongNet_PanNuke_1": _kongnet_entry(
            dict(enumerate(("Neoplastic", "Inflammatory", "Connective", "Dead", "Epithelial"))),
            11, 6, [5, 8, 11, 14, 17], 0.25, 256, 240,
        ),
        "efficientunet-tissue_mask": {
            "architecture": {
                "class": "efficientunet_tissue_mask_model.EfficientUNetTissueMaskModel",
                "kwargs": {"num_output_channels": 1, "threshold": 0.95},
            },
            "ioconfig": _segmentor_ioconfig(8.0, 512, 512, 480, tile=None),
        },
        "grandqc_tissue_detection": {
            "architecture": {
                "class": "grandqc.GrandQCModel",
                "kwargs": {"class_dict": {0: "Background", 1: "Tissue"}, "num_output_channels": 2},
            },
            "ioconfig": _segmentor_ioconfig(10.0, 512, 512, 256, tile=None, ignore_index=0),
        },
        "nuclick_light-pannuke": {
            "architecture": {
                "class": "unet.UNetModel",
                "kwargs": {
                    "decoder_block": [3, 3],
                    "encoder": "unet",
                    "encoder_levels": [32, 64, 128, 256],
                    "num_input_channels": 5,
                    "num_output_channels": 1,
                    "skip_type": "add",
                },
            },
            "ioconfig": _baseline_ioconfig(0.25, 128, 128, None, 1.0),
        },
        "nuclick_original-pannuke": {
            "architecture": {"class": "nuclick.NuClick", "kwargs": {"num_input_channels": 5, "num_output_channels": 1}},
            "ioconfig": _baseline_ioconfig(0.25, 128, 128, None, 1.0),
        },
        "unet_tissue_mask_tsef": {
            "architecture": {
                "class": "unet.UNetModel",
                "kwargs": {
                    "decoder_block": [3, 3],
                    "encoder": "resnet50",
                    "num_input_channels": 3,
                    "num_output_channels": 3,
                },
            },
            "ioconfig": _baseline_ioconfig(1.0, 1024, 512, 256, 1.0),
        },
    }
)
