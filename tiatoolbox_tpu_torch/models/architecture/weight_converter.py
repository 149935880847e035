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

The patch-classifier zoo and the tile encoders have no torch -> flax
converter in the JAX package beyond ``torch_vit_to_flax`` (:127-200), so
their flax names are read from the flax modules: ``flax_cnn_backbone_to_torch``
maps ``cnn_backbones.py``'s (``c0``, ``conv0``, ``db0_l0``, ``stem_conv``,
``b1_0/dw_conv``, ``se1``, ``i3a/p2b_bn``, ``b1_p2b_bn``...) to torchvision's,
``flax_efficientnet_to_torch`` ``efficientnet.py``'s (``stem_conv``,
``s1_b0/expand_conv``...) to timm's, and ``flax_vit_to_torch``, the inverse
of ``torch_vit_to_flax``, packs flax's ``query``, ``key`` and ``value``
kernels into timm's ``qkv``; ``flax_timm_to_torch`` puts either encoder
under ``feat_extract`` (with ``classifier`` for ``TimmModel``).

The registry's last models have JAX converters again, and the port has
their inverses: ``flax_kongnet_to_torch`` (``torch_kongnet_to_flax``
:798-909; the encoder under ``encoder.model`` with timm's names),
``flax_grandqc_to_torch`` (:719-797), ``flax_efficientunet_to_torch``
(:640-716; ``efficientnet_pytorch``'s names) and ``flax_nuclick_to_torch``
(:555-628; its transpose convolutions flipped back as MicroNet's).

``flax_vgg_to_torch`` is the inverse of ``torch_vgg_to_flax`` (:221-232),
and ``torchvision_vgg16_features`` takes a torchvision ``vgg16`` state dict's
trunk by name, refusing other conv layouts as JAX's ``convert_for_model``
does (:235-243).

SAM's checkpoints are transformers' own (``SamModel``'s names, no flax
tree): ``sam_state_dict_from_numpy`` carries the names as they are, and
``load_sam_checkpoint`` reads a checkpoint directory into a ``SamNet``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import _MBV2
from tiatoolbox_tpu_torch.models.architecture.resnet import RESNET_CONFIGS


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


def _split_conv_bn(name: str) -> tuple[str, str]:
    """``p2b_conv`` -> (``p2b``, ``conv``); ``p2b_bn`` -> (``p2b``, ``bn``); a bare
    conv name (``b1_p2b``, ``dw``) -> (itself, ``conv``)."""
    for suffix in ("_conv", "_bn"):
        if name.endswith(suffix):
            return name[: -len(suffix)], suffix[1:]
    return name, "conv"


_GOOGLENET_BRANCHES = {
    "p1": "branch1", "p2a": "branch2.0", "p2b": "branch2.1", "p3a": "branch3.0", "p3b": "branch3.1", "p4": "branch4.1",
}
_GOOGLENET_STEM = {"stem1": "conv1", "stem2": "conv2", "stem3": "conv3"}
_INCEPTION_STEM = {
    "s1": "Conv2d_1a_3x3", "s2": "Conv2d_2a_3x3", "s3": "Conv2d_2b_3x3", "s4": "Conv2d_3b_1x1", "s5": "Conv2d_4a_3x3",
}
_INCEPTION_A = {
    "p1": "branch1x1", "p2a": "branch5x5_1", "p2b": "branch5x5_2", "p3a": "branch3x3dbl_1",
    "p3b": "branch3x3dbl_2", "p3c": "branch3x3dbl_3", "p4": "branch_pool",
}
_INCEPTION_C = {
    "p1": "branch1x1", "p2a": "branch7x7_1", "p2b": "branch7x7_2", "p2c": "branch7x7_3",
    **{f"p3{c}": f"branch7x7dbl_{i + 1}" for i, c in enumerate("abcde")}, "p4": "branch_pool",
}
_INCEPTION_E = {
    "p1": "branch1x1", "p2a": "branch3x3_1", "p2b": "branch3x3_2a", "p2c": "branch3x3_2b", "p3a": "branch3x3dbl_1",
    "p3b": "branch3x3dbl_2", "p3c": "branch3x3dbl_3a", "p3d": "branch3x3dbl_3b", "p4": "branch_pool",
}
_INCEPTION_BLOCKS = {
    "a1": ("Mixed_5b", _INCEPTION_A), "a2": ("Mixed_5c", _INCEPTION_A), "a3": ("Mixed_5d", _INCEPTION_A),
    "rA": ("Mixed_6a", {"1": "branch3x3", "2a": "branch3x3dbl_1", "2b": "branch3x3dbl_2", "2c": "branch3x3dbl_3"}),
    "b1": ("Mixed_6b", _INCEPTION_C), "b2": ("Mixed_6c", _INCEPTION_C), "b3": ("Mixed_6d", _INCEPTION_C),
    "b4": ("Mixed_6e", _INCEPTION_C),
    "rB": ("Mixed_7a", {
        "1a": "branch3x3_1", "1b": "branch3x3_2", "2a": "branch7x7x3_1", "2b": "branch7x7x3_2",
        "2c": "branch7x7x3_3", "2d": "branch7x7x3_4",
    }),
    "c1": ("Mixed_7b", _INCEPTION_E), "c2": ("Mixed_7c", _INCEPTION_E),
}


def _alexnet_name(rest, params) -> str:  # noqa: ARG001
    return f"features.{(0, 3, 6, 8, 10)[int(rest[0][1:])]}"


def _densenet_name(rest, params) -> str:  # noqa: ARG001
    name = rest[0]
    fixed = {"conv0": "conv0", "bn0": "norm0", "bn_final": "norm5"}
    if name in fixed:
        return f"features.{fixed[name]}"
    layer = re.fullmatch(r"db(\d+)_l(\d+)", name)
    if layer:
        part = {"bn1": "norm1", "conv1": "conv1", "bn2": "norm2", "conv2": "conv2"}[rest[1]]
        return f"features.denseblock{int(layer.group(1)) + 1}.denselayer{int(layer.group(2)) + 1}.{part}"
    trans = re.fullmatch(r"trans(\d+)_(bn|conv)", name)
    return f"features.transition{int(trans.group(1)) + 1}.{'norm' if trans.group(2) == 'bn' else 'conv'}"


def _mobilenet_v2_name(rest, params) -> str:
    name = rest[0]
    if name in ("stem_conv", "stem_bn"):
        return f"features.0.{int(name == 'stem_bn')}"
    if name in ("head_conv", "head_bn"):
        return f"features.{1 + sum(n for _, _, n, _ in _MBV2)}.{int(name == 'head_bn')}"
    stage, block = (int(v) for v in name[1:].split("_"))
    o = int("expand_conv" in params[name])
    part = {
        "expand_conv": "0.0", "expand_bn": "0.1", "dw_conv": f"{o}.0", "dw_bn": f"{o}.1",
        "project": f"{o + 1}", "project_bn": f"{o + 2}",
    }[rest[1]]
    return f"features.{1 + sum(n for _, _, n, _ in _MBV2[:stage]) + block}.conv.{part}"


def _mobilenet_v3_name(rest, params) -> str:
    name = rest[0]
    blocks = sorted(int(k[1:]) for k in params if re.fullmatch(r"b\d+", k))
    if name in ("stem", "stem_bn"):
        return f"features.0.{int(name == 'stem_bn')}"
    if name in ("head", "head_bn"):
        return f"features.{len(blocks) + 1}.{int(name == 'head_bn')}"
    kids = params[name]
    o = int("expand" in kids)
    se = int("se1" in kids)
    part = {
        "expand": "0.0", "expand_bn": "0.1", "dw": f"{o}.0", "dw_bn": f"{o}.1",
        "se1": f"{o + 1}.fc1", "se2": f"{o + 1}.fc2", "project": f"{o + 1 + se}.0", "project_bn": f"{o + 1 + se}.1",
    }[rest[1]]
    return f"features.{int(name[1:]) + 1}.block.{part}"


def _googlenet_name(rest, params) -> str:  # noqa: ARG001
    if len(rest) == 1:  # stem1_conv ... stem3_bn
        base, part = _split_conv_bn(rest[0])
        return f"{_GOOGLENET_STEM[base]}.{part}"
    base, part = _split_conv_bn(rest[1])
    return f"inception{rest[0][1:]}.{_GOOGLENET_BRANCHES[base]}.{part}"


def _inception_v3_name(rest, params) -> str:  # noqa: ARG001
    base, part = _split_conv_bn(rest[0])
    if base in _INCEPTION_STEM:
        return f"{_INCEPTION_STEM[base]}.{part}"
    block, branch = base.split("_", 1)
    torch_block, branches = _INCEPTION_BLOCKS[block]
    return f"{torch_block}.{branches[branch]}.{part}"


_BACKBONE_NAMES = {
    "alexnet": _alexnet_name,
    "densenet": _densenet_name,
    "mobilenet_v2": _mobilenet_v2_name,
    "mobilenet_v3": _mobilenet_v3_name,
    "googlenet": _googlenet_name,
    "inception_v3": _inception_v3_name,
}


def flax_cnn_backbone_to_torch(
    variables: dict,
    backbone: str,
    backbone_name: str = "backbone",
    classifier_name: str = "classifier",
) -> dict[str, torch.Tensor]:
    """Convert flax ``CNNModel``/``CNNBackbone`` variables of any registry
    backbone to the port's ``state_dict`` (``feat_extract.*`` with
    torchvision's names, ``classifier.*``); the ResNets go through
    ``flax_resnet_to_torch``."""
    if backbone in RESNET_CONFIGS:
        return flax_resnet_to_torch(variables, backbone_name, classifier_name)
    family = next(f for f in _BACKBONE_NAMES if backbone.startswith(f))
    name_of = _BACKBONE_NAMES[family]
    params = variables["params"][backbone_name]

    def module_path(path: tuple[str, ...]) -> str:
        head, *rest = path
        if head == classifier_name:
            return "classifier"
        return f"feat_extract.{name_of(rest, params)}"

    return _convert(variables, module_path)


_MBCONV_EXPAND = {
    "expand_conv": "conv_pw", "expand_bn": "bn1", "dw_conv": "conv_dw", "dw_bn": "bn2",
    "se_reduce": "se.conv_reduce", "se_expand": "se.conv_expand", "project_conv": "conv_pwl", "project_bn": "bn3",
}
_MBCONV_DS = {
    "dw_conv": "conv_dw", "dw_bn": "bn1", "se_reduce": "se.conv_reduce", "se_expand": "se.conv_expand",
    "project_conv": "conv_pw", "project_bn": "bn2",
}
_FUSED = {"expand_conv": "conv_exp", "expand_bn": "bn1", "project_conv": "conv_pwl", "project_bn": "bn2"}
_CONV_BN_ACT = {"conv": "conv", "bn": "bn1"}
_EFFICIENTNET_TOP = {
    "stem_conv": "conv_stem", "stem_bn": "bn1", "head_conv": "conv_head", "head_bn": "bn2", "classifier": "classifier",
}


def _timm_efficientnet_name(path, params: dict) -> str:
    """timm's name of a flax EfficientNet module path (``stem_conv``,
    ``s1_b0/expand_conv``...) in the encoder whose params are ``params``."""
    head, *rest = path
    if head in _EFFICIENTNET_TOP:
        return _EFFICIENTNET_TOP[head]
    stage, block = re.fullmatch(r"s(\d+)_b(\d+)", head).groups()
    kids = params[head]
    if "dw_conv" in kids:
        table = _MBCONV_EXPAND if "expand_conv" in kids else _MBCONV_DS
    else:
        table = _FUSED if "expand_conv" in kids else _CONV_BN_ACT
    return f"blocks.{stage}.{block}.{table[rest[0]]}"


def flax_efficientnet_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``EfficientNetEncoder``, ``EfficientNetV2Encoder`` or
    ``EfficientNetClassifier`` (its trunk under "encoder") variables to a
    timm-named ``state_dict``."""
    params = variables["params"]

    def module_path(path: tuple[str, ...]) -> str:
        if path[0] == "encoder":
            return _timm_efficientnet_name(path[1:], params["encoder"])
        return _timm_efficientnet_name(path, params)

    return _convert(variables, module_path)


def _t(value) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def flax_vit_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``VisionTransformer`` variables to a timm-named
    ``state_dict``: the inverse of ``torch_vit_to_flax`` (JAX :127-200).

    Flax's per-head ``query``/``key``/``value`` kernels ``[D, H, d]`` pack
    into ``qkv.weight`` ``[3D, D]``, and ``out`` ``[H, d, D]`` becomes
    ``proj.weight`` ``[D, D]``; only transposes and reshapes, so the
    round trip is exact.
    """
    p = variables["params"]
    kernel = np.asarray(p["patch_embed"]["kernel"])
    state = {
        "patch_embed.proj.weight": _t(kernel.transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
        "cls_token": _t(p["cls_token"]),
        "pos_embed": _t(p["pos_embed"]),
        "norm.weight": _t(p["norm"]["scale"]),
        "norm.bias": _t(p["norm"]["bias"]),
    }
    if "reg_tokens" in p:
        state["reg_token"] = _t(p["reg_tokens"])
    depth = sum(1 for k in p if re.fullmatch(r"block\d+", k))
    for i in range(depth):
        block, pre = p[f"block{i}"], f"blocks.{i}."
        attn = block["attn"]
        dim = np.asarray(attn["query"]["kernel"]).shape[0]
        qkv = [np.asarray(attn[part]["kernel"]).reshape(dim, dim).T for part in ("query", "key", "value")]
        state[pre + "attn.qkv.weight"] = _t(np.concatenate(qkv, axis=0))
        state[pre + "attn.qkv.bias"] = _t(
            np.concatenate([np.asarray(attn[part]["bias"]).reshape(dim) for part in ("query", "key", "value")])
        )
        state[pre + "attn.proj.weight"] = _t(np.asarray(attn["out"]["kernel"]).reshape(dim, dim).T)
        state[pre + "attn.proj.bias"] = _t(attn["out"]["bias"])
        for norm in ("norm1", "norm2"):
            state[pre + f"{norm}.weight"] = _t(block[norm]["scale"])
            state[pre + f"{norm}.bias"] = _t(block[norm]["bias"])
        for fc in ("fc1", "fc2"):
            state[pre + f"mlp.{fc}.weight"] = _t(np.asarray(block["mlp"][fc]["kernel"]).T)
            state[pre + f"mlp.{fc}.bias"] = _t(block["mlp"][fc]["bias"])
        for ls in ("ls1", "ls2"):
            if ls in block:
                state[pre + f"{ls}.gamma"] = _t(block[ls])
    return state


def flax_timm_to_torch(variables: dict, *, classifier: bool) -> dict[str, torch.Tensor]:
    """Convert flax ``TimmBackbone`` (the encoder's variables) or, with
    ``classifier``, ``TimmModel`` variables (``encoder`` and ``classifier``)
    to the port's ``state_dict`` (``feat_extract.*``, ``classifier.*``)."""
    encoder = variables
    if classifier:
        encoder = {c: tree["encoder"] for c, tree in variables.items() if "encoder" in tree}
    convert = flax_vit_to_torch if "patch_embed" in encoder["params"] else flax_efficientnet_to_torch
    state = {f"feat_extract.{k}": v for k, v in convert(encoder).items()}
    if classifier:
        head = variables["params"]["classifier"]
        state["classifier.weight"] = _t(np.asarray(head["kernel"]).T)
        state["classifier.bias"] = _t(head["bias"])
    return state


_SCSE = {"cse_reduce": "cSE.1", "cse_expand": "cSE.3", "sse": "sSE.0"}


def _seq_index(leaf_module: str) -> str:
    """Index of a flax ``conv``/``bn`` pair's member in upstream's
    ``Sequential(conv, bn, act)``."""
    return "0" if leaf_module == "conv" else "1"


def flax_kongnet_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``KongNet`` variables to an upstream-named ``state_dict``:
    the inverse of ``torch_kongnet_to_flax`` (JAX :798-909). The encoder goes
    under ``encoder.model`` with timm's names; ``decoder{i}/center`` to
    ``decoders.i.center.attention.attention``, ``block{j}/up_conv{c}`` to
    ``blocks.j.up.conv{c}``, ``att{k}`` to ``attention{k}.attention``, the SCSE
    convs ``cse_reduce``/``cse_expand``/``sse`` to ``cSE.1``/``cSE.3``/``sSE.0``,
    and ``head{i}`` to ``heads.i.0``."""
    params = variables["params"]

    def module_path(path: tuple[str, ...]) -> str:
        head, *rest = path
        if head == "encoder":
            return "encoder.model." + _timm_efficientnet_name(rest, params["encoder"])
        if head.startswith("head"):
            return f"heads.{head[4:]}.0"
        dec = f"decoders.{head[len('decoder'):]}"
        if rest[0] == "center":
            return f"{dec}.center.attention.attention.{_SCSE[rest[1]]}"
        block, part = f"{dec}.blocks.{rest[0][len('block'):]}", rest[1]
        if part in ("att1", "att2"):
            return f"{block}.attention{part[-1]}.attention.{_SCSE[rest[2]]}"
        if part.startswith("up_"):
            return f"{block}.up.{part[3:]}.{_seq_index(rest[2])}"
        return f"{block}.{part}.{_seq_index(rest[2])}"

    return _convert(variables, module_path)


def _unet_block_name(block: str, layer: str) -> str:
    """Upstream name of a flax decoder block's ``conv{i}``/``bn{i}``:
    ``{block}.conv{i + 1}.{0 or 1}``."""
    kind, idx = re.fullmatch(r"(conv|bn)(\d)", layer).groups()
    return f"{block}.conv{int(idx) + 1}.{_seq_index(kind)}"


def flax_grandqc_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``GrandQCModel`` variables to an upstream-named
    ``state_dict``: the inverse of ``torch_grandqc_to_flax`` (JAX :719-797)."""
    params = variables["params"]

    def module_path(path: tuple[str, ...]) -> str:
        head, *rest = path
        if head == "encoder":
            return "encoder." + _timm_efficientnet_name(rest, params["encoder"])
        if head == "head":
            return "segmentation_head.0"
        return _unet_block_name(f"decoder.blocks.{rest[0]}", rest[1])

    return _convert(variables, module_path)


_EFFICIENTNET_PYTORCH_BLOCK = {
    "expand_conv": "_expand_conv", "expand_bn": "_bn0", "dw_conv": "_depthwise_conv", "dw_bn": "_bn1",
    "se_reduce": "_se_reduce", "se_expand": "_se_expand", "project_conv": "_project_conv", "project_bn": "_bn2",
}
# the flat index of each B0 stage's first block (``_B0_BLOCK_MAP``, JAX :641-647)
_B0_STAGE_START = np.cumsum([0, 1, 2, 2, 3, 3, 4])


def flax_efficientunet_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``EfficientUNetTissueMaskModel`` variables to an upstream
    (``efficientnet_pytorch``) named ``state_dict``: the inverse of
    ``torch_efficientunet_to_flax`` (JAX :640-716). The flax model has no
    ``_conv_head``/``_bn1``, which the checkpoint holds and the forward does
    not use: they come out as zeros and an identity batch norm."""

    def module_path(path: tuple[str, ...]) -> str:
        head, *rest = path
        if head == "encoder":
            if rest[0] in ("stem_conv", "stem_bn"):
                return "encoder._conv_stem" if rest[0] == "stem_conv" else "encoder._bn0"
            stage, block = (int(v) for v in re.fullmatch(r"s(\d+)_b(\d+)", rest[0]).groups())
            return f"encoder._blocks.{_B0_STAGE_START[stage] + block}.{_EFFICIENTNET_PYTORCH_BLOCK[rest[1]]}"
        if head == "head":
            return "segmentation_head.0"
        return _unet_block_name(f"decoder.blocks.{head[3:]}", rest[0])

    state = _convert(variables, module_path)
    width = state["encoder._blocks.15._bn2.weight"].shape[0]
    state["encoder._conv_head.weight"] = torch.zeros(1280, width, 1, 1)
    state["encoder._bn1.weight"] = torch.ones(1280)
    state["encoder._bn1.bias"] = torch.zeros(1280)
    state["encoder._bn1.running_mean"] = torch.zeros(1280)
    state["encoder._bn1.running_var"] = torch.ones(1280)
    state["encoder._bn1.num_batches_tracked"] = torch.tensor(0)
    return state


def _nuclick_module_path(path: tuple[str, ...]) -> str:
    """Upstream NuClick name of a flax module path (``torch_nuclick_to_flax``)."""
    head, *rest = path
    if head.startswith("ct"):
        return f"conv_transpose_{head[2:]}"
    conv_block = re.fullmatch(r"cb(\d)(?:_(\d))?", head)
    if conv_block:
        block = f"conv_block_{conv_block.group(1)}"
        if conv_block.group(2) is not None:
            block += f".{conv_block.group(2)}"
        return f"{block}.conv_bn_relu.{_seq_index(rest[0])}"
    if head.startswith("ms"):
        block = f"multiscale_block_{head[2:]}.conv_block_{int(rest[0][1:]) + 1}"
    else:  # rb{k}, or rb{k}_{m} in a sequence; c1 / c2
        number, member = re.fullmatch(r"rb(\d+)(?:_(\d+))?", head).groups()
        block = f"residual_block_{number}" + (f".{member}" if member is not None else "")
        block += f".conv_block_{rest[0][1:]}"
    return f"{block}.conv_bn_relu.{_seq_index(rest[1])}"


def flax_nuclick_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``NuClick`` variables to an upstream-named ``state_dict``:
    the inverse of ``torch_nuclick_to_flax`` (JAX :555-628); the transpose
    convolutions' kernels are flipped back as MicroNet's are."""
    return _convert(variables, _nuclick_module_path, transposed=lambda module: module.startswith("conv_transpose"))


def flax_vgg_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert flax ``VGG16Features`` variables (``conv{i}``) to torchvision's
    ``features.{i}`` names: the inverse of ``torch_vgg_to_flax`` (JAX
    :221-232)."""
    return _convert(variables, lambda path: f"features.{path[0].removeprefix('conv')}")


def torchvision_vgg16_features(state_dict: dict) -> dict[str, torch.Tensor]:
    """The ``features.*`` conv weights of a torchvision ``vgg16`` state dict
    (``module.`` prefixes stripped; ``classifier.*`` and other entries left
    out), checked against VGG16's conv indices as JAX's ``convert_for_model``
    gates on the target module (:235-243).

    Raises:
        ValueError: a VGG16 conv is missing, or the checkpoint has convs at
            other indices (vgg19, vgg16_bn, ...).
    """
    from tiatoolbox_tpu_torch.models.architecture.vgg import VGG16_CONV_IDS

    state = {k.removeprefix("module."): v for k, v in state_dict.items()}
    found = {int(m.group(1)) for k in state if (m := re.fullmatch(r"features\.(\d+)\.weight", k))}
    if found != set(VGG16_CONV_IDS):
        msg = (
            f"Not a torchvision vgg16 checkpoint: conv weights at features {sorted(found)}, "
            f"VGG16's are at {list(VGG16_CONV_IDS)}."
        )
        raise ValueError(msg)
    return {
        f"features.{i}.{leaf}": torch.as_tensor(state[f"features.{i}.{leaf}"]).float()
        for i in VGG16_CONV_IDS
        for leaf in ("weight", "bias")
    }


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


_SAM_TIED = ("prompt_encoder.shared_embedding.positional_embedding", "shared_image_embedding.positional_embedding")


def sam_state_dict_from_numpy(mapping: dict) -> dict[str, torch.Tensor]:
    """transformers' ``SamModel`` names carried as they are into float32 CPU
    tensors (numpy arrays or tensors in); the prompt encoder's Fourier
    matrix is the model's, which ``save_pretrained`` leaves out of the file
    (``SamModel._tie_weights``, ``modeling_sam.py:1130``)."""
    state = {}
    for name, value in mapping.items():
        tensor = value.detach().cpu() if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
        state[name] = tensor.float() if tensor.is_floating_point() else tensor
    tied, shared = _SAM_TIED
    if shared in state:
        state[tied] = state[shared]
    return state


def load_sam_checkpoint(directory, device=None):
    """The ``SamNet`` of a local checkpoint directory: ``config.json`` and
    ``model.safetensors`` (else ``pytorch_model.bin``), loaded strictly.

    Raises:
        FileNotFoundError: no ``config.json`` or no weights file.
        RuntimeError: a name missing from the file, or one the network lacks.
    """
    from pathlib import Path

    from tiatoolbox_tpu_torch.models.architecture.sam import build_sam_net
    from tiatoolbox_tpu_torch.models.architecture.sam_config import read_sam_config
    from tiatoolbox_tpu_torch.utils.safetensors_lite import load_checkpoint_file

    directory = Path(directory)
    config = read_sam_config(directory)
    for name in ("model.safetensors", "pytorch_model.bin"):
        if (directory / name).is_file():
            state = sam_state_dict_from_numpy(load_checkpoint_file(directory / name))
            return build_sam_net(config, state, device)
    msg = f"{directory} holds neither model.safetensors nor pytorch_model.bin."
    raise FileNotFoundError(msg)
