"""Model architectures of the port and the pretrained registry.

``get_pretrained_model`` is the counterpart of
``tiatoolbox_tpu/models/architecture/__init__.py:89``: it builds a registry
model and its ioconfig. Weights load from a local ``.pth`` ``state_dict``
only; without one the model keeps its seeded random initialisation.
"""

from __future__ import annotations

from pathlib import Path

import torch

from tiatoolbox_tpu_torch import PRETRAINED_MODELS, logger


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
    from tiatoolbox_tpu_torch.models.architecture import vanilla
    from tiatoolbox_tpu_torch.models.dataset.classification import predefined_preproc_func
    from tiatoolbox_tpu_torch.models.engine import io_config

    if pretrained_model not in PRETRAINED_MODELS:
        msg = f"Pretrained model `{pretrained_model}` does not exist."
        raise ValueError(msg)
    cfg = PRETRAINED_MODELS[pretrained_model]
    arch = cfg["architecture"]
    model = getattr(vanilla, arch["class"].rsplit(".", 1)[-1])(**arch["kwargs"], device=device)
    if pretrained_weights is not None:
        model.load_state_dict(torch.load(pretrained_weights, map_location="cpu"))
    else:
        logger.warning(
            "No weights given for %s; using the seeded random initialisation.",
            pretrained_model,
        )
    model.preproc_func = predefined_preproc_func(cfg["dataset"])
    io_cfg = cfg["ioconfig"]
    ioconfig = getattr(io_config, io_cfg["class"])(**io_cfg["kwargs"])
    return model, ioconfig
