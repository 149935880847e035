"""SAM's settings: ``config.json`` and ``preprocessor_config.json`` of a checkpoint.

``SamConfig()`` is transformers' ``SamConfig()`` (``configuration_sam.py``,
transformers 4.57): ViT-B, width 768, 12 layers of 12 heads, global
attention at layers 2, 5, 8 and 11, windows of 14 tokens, 1024^2 input in
16^2 patches, a 256-channel neck; a 256-wide prompt encoder and mask
decoder (2 two-way layers of 8 heads, MLP 2048, 3 multimask outputs, a
3-layer IoU head). ``read_sam_config`` reads a checkpoint's ``config.json``
over those defaults, as ``SamConfig.from_pretrained`` does, and refuses
the settings the port does not implement (activations other than
transformers' defaults; ``qkv_bias``, ``use_abs_pos`` or ``use_rel_pos``
switched off, which no published SAM checkpoint does), naming each.

``PreprocessorConfig()`` is ``SamImageProcessor()``'s
(``image_processing_sam.py:118-165``): the longest edge resized to 1024,
zeros padded to 1024^2, ImageNet mean and std, 1/255. Only ``resample: 2``
(PIL's bilinear, which every published SAM checkpoint ships) is accepted:
the port's resample is bit for bit PIL's bilinear and nothing else.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path


def _refuse(section: str, key: str, value, accepted) -> None:
    if value != accepted:
        msg = f"SAM {section} setting {key}={value!r} is not supported by the port (it takes {accepted!r})."
        raise ValueError(msg)


@dataclass(frozen=True)
class SamVisionConfig:
    """The image encoder (``SamVisionConfig``, ``configuration_sam.py:104``)."""

    hidden_size: int = 768
    output_channels: int = 256
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 1024
    patch_size: int = 16
    layer_norm_eps: float = 1e-6
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11)
    num_pos_feats: int = 128
    mlp_dim: int | None = None  # hidden_size * mlp_ratio where None, as transformers sets it

    def __post_init__(self) -> None:
        if self.mlp_dim is None:
            object.__setattr__(self, "mlp_dim", int(self.hidden_size * self.mlp_ratio))

    @property
    def grid(self) -> int:
        """Tokens along a side of the patch grid."""
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class SamPromptEncoderConfig:
    """The prompt encoder (``SamPromptEncoderConfig``, ``configuration_sam.py:5``)."""

    hidden_size: int = 256
    image_size: int = 1024
    patch_size: int = 16
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    layer_norm_eps: float = 1e-6

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class SamMaskDecoderConfig:
    """The mask decoder (``SamMaskDecoderConfig``, ``configuration_sam.py:48``)."""

    hidden_size: int = 256
    mlp_dim: int = 2048
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class SamConfig:
    """The three parts of ``SamConfig`` (``configuration_sam.py:210``)."""

    vision_config: SamVisionConfig = field(default_factory=SamVisionConfig)
    prompt_encoder_config: SamPromptEncoderConfig = field(default_factory=SamPromptEncoderConfig)
    mask_decoder_config: SamMaskDecoderConfig = field(default_factory=SamMaskDecoderConfig)

    def to_json_dict(self) -> dict:
        """``config.json`` as ``SamConfig.save_pretrained`` lays it out."""
        out = {"architectures": ["SamModel"], "model_type": "sam"}
        for name in ("vision_config", "prompt_encoder_config", "mask_decoder_config"):
            part = asdict(getattr(self, name))
            if name == "vision_config":
                part["global_attn_indexes"] = list(part["global_attn_indexes"])
                part["hidden_act"] = "gelu"
            elif name == "mask_decoder_config":
                part["hidden_act"] = "relu"
            out[name] = part
        return out


def _section(cls, raw: dict, section: str):
    """The dataclass ``cls`` from the keys of ``raw`` it knows; the rest are
    transformers' bookkeeping (``model_type``, ``initializer_range``...)."""
    known = {k: raw[k] for k in cls.__dataclass_fields__ if k in raw}
    if "global_attn_indexes" in known:
        known["global_attn_indexes"] = tuple(known["global_attn_indexes"])
    if section == "vision_config":
        _refuse(section, "hidden_act", raw.get("hidden_act", "gelu"), "gelu")
        for switch in ("qkv_bias", "use_abs_pos", "use_rel_pos"):
            _refuse(section, switch, raw.get(switch, True), True)
    if section == "mask_decoder_config":
        _refuse(section, "hidden_act", raw.get("hidden_act", "relu"), "relu")
    return cls(**known)


def sam_config_from_dict(raw: dict) -> SamConfig:
    """A ``SamConfig`` from the dict of a ``config.json``."""
    return SamConfig(
        vision_config=_section(SamVisionConfig, raw.get("vision_config") or {}, "vision_config"),
        prompt_encoder_config=_section(
            SamPromptEncoderConfig, raw.get("prompt_encoder_config") or {}, "prompt_encoder_config"
        ),
        mask_decoder_config=_section(
            SamMaskDecoderConfig, raw.get("mask_decoder_config") or {}, "mask_decoder_config"
        ),
    )


def read_sam_config(directory: str | Path) -> SamConfig:
    """``directory/config.json`` over transformers' defaults."""
    return sam_config_from_dict(json.loads((Path(directory) / "config.json").read_text()))


@dataclass(frozen=True)
class PreprocessorConfig:
    """``SamImageProcessor``'s settings that the port reads."""

    longest_edge: int = 1024
    pad_height: int = 1024
    pad_width: int = 1024
    image_mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    rescale_factor: float = 1 / 255

    def to_json_dict(self) -> dict:
        """``preprocessor_config.json`` as ``SamProcessor.save_pretrained`` lays it out."""
        return {
            "do_convert_rgb": True,
            "do_normalize": True,
            "do_pad": True,
            "do_rescale": True,
            "do_resize": True,
            "image_mean": list(self.image_mean),
            "image_processor_type": "SamImageProcessor",
            "image_std": list(self.image_std),
            "pad_size": {"height": self.pad_height, "width": self.pad_width},
            "processor_class": "SamProcessor",
            "resample": 2,
            "rescale_factor": self.rescale_factor,
            "size": {"longest_edge": self.longest_edge},
        }


def preprocessor_config_from_dict(raw: dict) -> PreprocessorConfig:
    """A ``PreprocessorConfig`` from the dict of a ``preprocessor_config.json``.

    Raises:
        ValueError: ``resample`` other than 2 (bilinear), a step switched off
            (``do_resize``, ``do_rescale``, ``do_normalize``, ``do_pad``), or
            a ``size`` without ``longest_edge``.
    """
    section = "preprocessor"
    _refuse(section, "resample", raw.get("resample", 2), 2)
    for step in ("do_resize", "do_rescale", "do_normalize", "do_pad"):
        _refuse(section, step, raw.get(step, True), True)
    size = raw.get("size") or {"longest_edge": 1024}
    if "longest_edge" not in size:
        msg = f"SAM preprocessor setting size={size!r} has no longest_edge."
        raise ValueError(msg)
    pad = raw.get("pad_size") or {"height": 1024, "width": 1024}
    defaults = PreprocessorConfig()
    return PreprocessorConfig(
        longest_edge=int(size["longest_edge"]),
        pad_height=int(pad["height"]),
        pad_width=int(pad["width"]),
        image_mean=tuple(raw.get("image_mean", defaults.image_mean)),
        image_std=tuple(raw.get("image_std", defaults.image_std)),
        rescale_factor=float(raw.get("rescale_factor", defaults.rescale_factor)),
    )


def read_preprocessor_config(directory: str | Path) -> PreprocessorConfig:
    """``directory/preprocessor_config.json`` over ``SamImageProcessor()``'s defaults."""
    return preprocessor_config_from_dict(json.loads((Path(directory) / "preprocessor_config.json").read_text()))
