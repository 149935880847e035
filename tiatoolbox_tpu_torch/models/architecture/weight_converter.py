"""Flax variables -> PyTorch ``state_dict``, and flax ``.npz`` files.

``flax_resnet_to_torch`` is the inverse of ``torch_resnet_to_flax``
(``tiatoolbox_tpu/models/architecture/weight_converter.py:28-97``) and
``flax_unet_to_torch`` the inverse of ``torch_unet_to_flax`` (:910-988),
``flax_hovernet_to_torch`` the inverse of ``torch_hovernet_to_flax``
(:354-462, HoVerNet+'s ``ls`` branch included),
``flax_micronet_to_torch``, ``flax_mapde_to_torch`` and
``flax_sccnn_to_torch`` the inverses of ``torch_micronet_to_flax`` (:490),
``torch_mapde_to_flax`` (:629) and ``torch_sccnn_to_flax`` (:473):
conv kernels HWIO -> OIHW, transpose-conv kernels HWIO -> IOHW flipped in
both spatial axes (flax applies them unflipped, ``_convT_kernel``
:463-470), dense kernels [in, out] -> [out, in], and batch-norm
scale/bias/mean/var -> weight/bias/running_mean/running_var.
Keys follow the reference tiatoolbox models (``CNNModel``: ``feat_extract.*``
with torchvision names inside, ``classifier.*``; ``UNetModel``:
``backbone.*``, ``conv1x1``, ``uplist.*``, ``clf``; ``HoVerNet``:
``conv0./``, ``d0.units.0.conv1/bn``, ``decoder.np.u3.dense.*``;
``MicroNet`` and MapDe's trunk: ``layer.b1.conv1.0``, ``layer.b6.up1``;
``SCCNN``: ``layer.l1.conv1.0``), so the same ``state_dict`` is what a
reference ``.pth`` holds, less the fixed buffers the port computes (MapDe's
``dist_filter``, SCCNN's ``xv`` and ``yv``). ``load_flax_npz`` reads
the JAX package's flattened ``.npz`` variables (``load_flax_npz`` :114).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _resnet_names(prefix: str, rest) -> str:
    """torchvision names of a flax ResNet path under ``prefix``."""
    parts = [prefix]
    for name in rest:
        block = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if block:
            parts += [f"layer{block.group(1)}", block.group(2)]
        elif name == "downsample_conv":
            parts += ["downsample", "0"]
        elif name == "downsample_bn":
            parts += ["downsample", "1"]
        else:
            parts.append(name)
    return ".".join(parts)


def _torch_module_path(path: tuple[str, ...], backbone_name: str, classifier_name: str) -> str:
    head, *rest = path
    if head == classifier_name:
        return "classifier"
    if head != backbone_name:
        msg = f"Unexpected top-level flax module {head!r}."
        raise ValueError(msg)
    return _resnet_names("feat_extract", rest)


def _leaves(tree: dict, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, (*prefix, key))
        else:
            yield (*prefix, key), np.asarray(value)


def flax_resnet_to_torch(
    variables: dict,
    backbone_name: str = "backbone",
    classifier_name: str = "classifier",
) -> dict[str, torch.Tensor]:
    """Convert flax ``CNNModel``/ResNet variables to a PyTorch ``state_dict``.

    Args:
        variables: ``{"params": ..., "batch_stats": ...}`` of the flax model.
        backbone_name / classifier_name: Top-level flax module names.

    Returns:
        ``state_dict`` for the port's ``CNNModel`` (float32 tensors, plus a
        zero ``num_batches_tracked`` per batch-norm layer).
    """
    return _convert(
        variables, lambda path: _torch_module_path(path, backbone_name, classifier_name)
    )


def _unet_module_path(path: tuple[str, ...], pre_activation: bool) -> str:
    head, *rest = path
    if head == "backbone":
        block = re.fullmatch(r"block(\d+)_(conv|bn)(\d+)", rest[0])
        if block is None:  # resnet50 encoder
            return _resnet_names("backbone", rest)
        seq = 3 * int(block.group(3)) + int(block.group(2) == "bn")
        return f"backbone.blocks.{block.group(1)}.0.{seq}"
    up = re.fullmatch(r"up(\d+)", head)
    if up:
        layer = re.fullmatch(r"(conv|bn)(\d+)", rest[0])
        is_conv = layer.group(1) == "conv"
        offset = (2 if is_conv else 0) if pre_activation else (0 if is_conv else 1)
        return f"uplist.{up.group(1)}.{3 * int(layer.group(2)) + offset}"
    if head in ("conv1x1", "clf"):
        return head
    msg = f"Unexpected top-level flax module {head!r}."
    raise ValueError(msg)


def flax_unet_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``UNetModel`` variables (either encoder) to a PyTorch ``state_dict``.

    The decoder blocks are pre-activation ([BN, ReLU, conv]) with the
    resnet50 encoder and [conv, BN, ReLU] with the unet encoder, as in
    ``torch_unet_to_flax``.
    """
    pre_activation = "conv1" in variables["params"]["backbone"]
    return _convert(variables, lambda path: _unet_module_path(path, pre_activation))


def _hovernet_module_path(path: tuple[str, ...]) -> str:
    """Upstream HoVerNet module name of a flax module path."""
    head, *rest = path
    if head == "conv0":
        return "conv0./"
    if head == "bn0":
        return "conv0.bn"
    if head == "conv_bot":
        return head
    if re.fullmatch(r"d\d", head):
        return f"{head}.{_unit_name(rest[0], preact='preact/bn')}"
    # decoder branch: np, hv, tp, ls
    name = rest[0]
    if name in ("u0_bn", "u0_conv"):
        return f"decoder.{head}.u0.{name[3:]}"
    stage, part = name.split("_", 1)
    if part == "dense":
        return f"decoder.{head}.{stage}.dense.{_unit_name(rest[1], preact='preact_bna/bn')}"
    return f"decoder.{head}.{stage}.{part}"


def _unit_name(name: str, preact: str) -> str:
    """``shortcut``, ``blk_bn``, ``u{j}_preact_bn``, ``u{j}_bn{c}`` or
    ``u{j}_conv{c}`` of a residual or dense block -> upstream name."""
    if name == "blk_bn":
        return "blk_bna.bn"
    if name == "shortcut":
        return name
    unit = re.fullmatch(r"u(\d+)_(preact_bn|bn(\d)|conv\d)", name)
    if unit is None:
        msg = f"Unexpected HoVerNet block member {name!r}."
        raise ValueError(msg)
    j, part, bn = unit.group(1), unit.group(2), unit.group(3)
    if part == "preact_bn":
        return f"units.{j}.{preact}"
    if bn is not None:
        return f"units.{j}.conv{bn}/bn"
    return f"units.{j}.{part}"


def flax_hovernet_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``HoVerNet`` (either mode) or ``HoVerNetPlus`` variables to an upstream-named ``state_dict``."""
    return _convert(variables, _hovernet_module_path)


def _micronet_module_path(path: tuple[str, ...]) -> str:
    """Upstream MicroNet module name of a flax module path (``torch_micronet_to_flax``)."""
    head, *rest = path
    if rest:  # b1-b4, b6-b9: convK, bn1 / bn3 (after conv1 / conv3's tanh), upK
        name = rest[0]
        if name.startswith("bn"):
            return f"layer.{head}.conv{name[2:]}.2"
        return f"layer.{head}.{name}" if name.startswith("up") else f"layer.{head}.{name}.0"
    block, name = head.rsplit("_", 1)  # b5_conv1, fm1_up1, fm1_conv1, aux_out1_conv, out_conv
    if name == "conv" and block.startswith(("aux_out", "out")):
        return f"layer.{block}.1"
    return f"layer.{block}.{name}" if name.startswith("up") else f"layer.{block}.{name}.0"


def _is_transposed(module: str) -> bool:
    """MicroNet's transpose convolutions: ``up1`` to ``up3``."""
    return module.rsplit(".", 1)[-1].startswith("up")


def flax_micronet_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``MicroNet`` variables to an upstream-named ``state_dict``."""
    return _convert(variables, _micronet_module_path, transposed=_is_transposed)


def flax_mapde_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``MapDe`` variables (the MicroNet trunk under "trunk") to an
    upstream-named ``state_dict``, without the fixed ``dist_filter``."""
    trunk = {collection: tree["trunk"] for collection, tree in variables.items() if "trunk" in tree}
    return flax_micronet_to_torch(trunk)


def flax_sccnn_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``SCCNN`` variables to an upstream-named ``state_dict``,
    without the fixed ``xv``/``yv`` grids."""
    return _convert(variables, lambda path: f"layer.{path[0]}.conv1.0")


def _convert(variables: dict, module_path, transposed=lambda module: False) -> dict[str, torch.Tensor]:
    """Flax leaves -> ``state_dict`` entries, under the names ``module_path``
    gives; a kernel of a module that ``transposed`` names is a transpose
    convolution's."""
    state: dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables["params"]):
        module = module_path(path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
            if transposed(module):
                value = value[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            state[f"{module}.weight"] = torch.from_numpy(np.ascontiguousarray(value))
        elif leaf == "scale":
            state[f"{module}.weight"] = torch.from_numpy(value.copy())
            state[f"{module}.num_batches_tracked"] = torch.tensor(0)
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.from_numpy(value.copy())
        else:
            msg = f"Unexpected flax parameter {'/'.join(path)}."
            raise ValueError(msg)
    names = {"mean": "running_mean", "var": "running_var"}
    for path, value in _leaves(variables.get("batch_stats", {})):
        module = module_path(path[:-1])
        state[f"{module}.{names[path[-1]]}"] = torch.from_numpy(value.copy())
    return {k: v.float() if v.is_floating_point() else v for k, v in state.items()}


def load_flax_npz(path) -> dict:
    """Load a flattened ``.npz`` of flax variables into a nested tree."""
    tree: dict = {}
    with np.load(path) as data:
        for flat_key in data.files:
            node = tree
            *parents, leaf = flat_key.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = data[flat_key]
    return tree
