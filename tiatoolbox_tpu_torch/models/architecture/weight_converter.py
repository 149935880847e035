"""Flax variables -> PyTorch ``state_dict``, and flax ``.npz`` files.

``flax_resnet_to_torch`` is the inverse of ``torch_resnet_to_flax``
(``tiatoolbox_tpu/models/architecture/weight_converter.py:28-97``) and
``flax_unet_to_torch`` the inverse of ``torch_unet_to_flax`` (:910-988):
conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in], and
batch-norm scale/bias/mean/var -> weight/bias/running_mean/running_var.
Keys follow the reference tiatoolbox models (``CNNModel``: ``feat_extract.*``
with torchvision names inside, ``classifier.*``; ``UNetModel``:
``backbone.*``, ``conv1x1``, ``uplist.*``, ``clf``), so the same
``state_dict`` is what a reference ``.pth`` holds. ``load_flax_npz`` reads
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


def _convert(variables: dict, module_path) -> dict[str, torch.Tensor]:
    """Flax leaves -> ``state_dict`` entries, under the names ``module_path`` gives."""
    state: dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables["params"]):
        module = module_path(path[:-1])
        leaf = path[-1]
        if leaf == "kernel":
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
