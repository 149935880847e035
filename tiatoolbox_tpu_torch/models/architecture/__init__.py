"""Model architectures of the port and the pretrained registry.

``get_pretrained_model`` is the counterpart of
``tiatoolbox_tpu/models/architecture/__init__.py:89``: it builds a registry
model (``vanilla.CNNModel`` over any of its 19 backbones, ``unet.UNetModel``, ``hovernet.HoVerNet``,
``hovernetplus.HoVerNetPlus``, ``micronet.MicroNet``, ``mapde.MapDe``,
``sccnn.SCCNN``, ``kongnet.KongNet``, ``grandqc.GrandQCModel``,
``efficientunet_tissue_mask_model.EfficientUNetTissueMaskModel`` or
``nuclick.NuClick``) and its ioconfig: every entry of the JAX registry.
Without ``pretrained_weights`` it looks for a local checkpoint first
(``fetch_pretrained_weights``, :21-43), in the JAX package's order: flax
``.npz``, then torch ``.pth`` and ``.tar`` ``state_dict``s. It never
downloads; without a checkpoint the model keeps its seeded random
initialisation.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import torch

from tiatoolbox_tpu_torch import PRETRAINED_MODELS, logger, rcParam


def fetch_pretrained_weights(model_name: str) -> Path | None:
    """The first of ``{name}.npz``, ``.pth`` and ``.tar`` under
    ``rcParam["TIATOOLBOX_HOME"]/models``, or None."""
    home = Path(rcParam["TIATOOLBOX_HOME"]) / "models"
    for suffix in (".npz", ".pth", ".tar"):
        candidate = home / f"{model_name}{suffix}"
        if candidate.exists():
            return candidate
    return None


def unwrap_checkpoint(checkpoint: dict) -> dict:
    """The ``state_dict`` inside a torch checkpoint: HoVer-Net's ``"desc"``,
    a ``"state_dict"`` and KongNet's ``"model"`` wrappers are taken off in
    that order (``weight_converter.py:291-300``)."""
    if "desc" in checkpoint:
        checkpoint = checkpoint["desc"]
    if "state_dict" in checkpoint:
        checkpoint = checkpoint["state_dict"]
    if isinstance(checkpoint.get("model"), dict):
        checkpoint = checkpoint["model"]
    return checkpoint


def load_weights(model, path: str | Path) -> None:
    """Load a flax ``.npz`` (through the converter) or a torch ``state_dict`` into ``model``."""
    from tiatoolbox_tpu_torch.models.architecture import weight_converter
    from tiatoolbox_tpu_torch.models.architecture.efficientunet_tissue_mask_model import (
        EfficientUNetTissueMaskModel,
    )
    from tiatoolbox_tpu_torch.models.architecture.grandqc import GrandQCModel
    from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet
    from tiatoolbox_tpu_torch.models.architecture.kongnet import KongNet
    from tiatoolbox_tpu_torch.models.architecture.mapde import MapDe
    from tiatoolbox_tpu_torch.models.architecture.micronet import MicroNet
    from tiatoolbox_tpu_torch.models.architecture.nuclick import NuClick
    from tiatoolbox_tpu_torch.models.architecture.sccnn import SCCNN
    from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
    from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone
    from tiatoolbox_tpu_torch.models.architecture.vit import TimmBackbone, TimmModel

    path = Path(path)
    if path.suffix == ".npz":
        variables = weight_converter.load_flax_npz(path)
        # MapDe is a MicroNet and TimmModel a TimmBackbone: the subclass first
        for cls, convert in (
            (HoVerNet, weight_converter.flax_hovernet_to_torch),
            (UNetModel, weight_converter.flax_unet_to_torch),
            (MapDe, weight_converter.flax_mapde_to_torch),
            (MicroNet, weight_converter.flax_micronet_to_torch),
            (SCCNN, weight_converter.flax_sccnn_to_torch),
            (KongNet, weight_converter.flax_kongnet_to_torch),
            (GrandQCModel, weight_converter.flax_grandqc_to_torch),
            (EfficientUNetTissueMaskModel, weight_converter.flax_efficientunet_to_torch),
            (NuClick, weight_converter.flax_nuclick_to_torch),
            (CNNBackbone, lambda v: weight_converter.flax_cnn_backbone_to_torch(v, model.backbone)),
            (TimmModel, lambda v: weight_converter.flax_timm_to_torch(v, classifier=True)),
            (TimmBackbone, lambda v: weight_converter.flax_timm_to_torch(v, classifier=False)),
        ):
            if isinstance(model, cls):
                break
        else:
            msg = f"No flax converter for {type(model).__name__}."
            raise TypeError(msg)
        state = convert(variables)
    else:
        state = unwrap_checkpoint(torch.load(path, map_location="cpu", weights_only=True))
        # fixed tables of the reference models, which the port computes: the
        # UNet's nearest-upsample matrix, MapDe's distance cone, SCCNN's grids
        for key in ("upsample2x.unpool_mat", "dist_filter", "xv", "yv"):
            state.pop(key, None)
        # modules an upstream checkpoint may hold that no forward runs: the
        # timm encoder's classifier head (GrandQC) and the SCSE before the
        # last KongNet decoder block, which has no skip to attend over
        unused = re.compile(r"encoder\.(conv_head|bn2)\.|decoders\.\d+\.blocks\.4\.attention1\.")
        if isinstance(model, (GrandQCModel, KongNet)):
            state = {k: v for k, v in state.items() if not unused.match(k)}
    model.load_state_dict(state)


def get_pretrained_model(
    pretrained_model: str,
    pretrained_weights: str | Path | None = None,
    device: str | torch.device | None = None,
):
    """Build a registry model and its ioconfig.

    The model is built on ``device`` (``rcParam["device"]`` by default).

    Returns:
        (ModelABC, ModelIOConfigABC) tuple.
    """
    from tiatoolbox_tpu_torch.models.dataset.classification import predefined_preproc_func
    from tiatoolbox_tpu_torch.models.engine import io_config

    if pretrained_model not in PRETRAINED_MODELS:
        msg = f"Pretrained model `{pretrained_model}` does not exist."
        raise ValueError(msg)
    cfg = PRETRAINED_MODELS[pretrained_model]
    arch = cfg["architecture"]
    module_name, class_name = arch["class"].rsplit(".", 1)
    module = importlib.import_module(f"tiatoolbox_tpu_torch.models.architecture.{module_name}")
    model = getattr(module, class_name)(**arch["kwargs"], device=device)
    if pretrained_weights is None:
        pretrained_weights = fetch_pretrained_weights(pretrained_model)
    if pretrained_weights is not None:
        load_weights(model, pretrained_weights)
    else:
        logger.warning(
            "No local weights found for %s under %s/models; using the seeded "
            "random initialisation.",
            pretrained_model,
            rcParam["TIATOOLBOX_HOME"],
        )
    if "dataset" in cfg:
        model.preproc_func = predefined_preproc_func(cfg["dataset"])
    io_cfg = cfg["ioconfig"]
    ioconfig = getattr(io_config, io_cfg["class"])(**io_cfg["kwargs"])
    return model, ioconfig


# the patch-classifier zoo and the tile encoders
from tiatoolbox_tpu_torch.models.architecture.efficientnet import (  # noqa: E402, F401
    EfficientNetClassifier,
    EfficientNetEncoder,
    EfficientNetV2Encoder,
)
from tiatoolbox_tpu_torch.models.architecture.idars import IDaRS  # noqa: E402, F401
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone, CNNModel  # noqa: E402, F401
from tiatoolbox_tpu_torch.models.architecture.vit import TimmBackbone, TimmModel, VisionTransformer  # noqa: E402, F401
