"""Vision Transformer tile encoders and the timm model wrappers, with timm's names.

Counterpart of ``tiatoolbox_tpu/models/architecture/vit.py`` (:21-237):
``_Mlp`` (:21, exact GELU, or SwiGLU on a packed ``fc1``: SiLU of the first
half times the second), ``_Block`` (:38, pre-norm, optional layer scale),
``VisionTransformer`` (:69, a CLS token, register tokens, ``pos_embed`` over
the CLS token and the patch grid, ``"cls"`` or ``"mean"`` pooling),
``VIT_CONFIGS`` (:140, the pathology foundation encoders), ``TimmModel``
(:177) and ``TimmBackbone`` (:213), which also take ``"efficientnet_b*"``
(``efficientnet.EfficientNetClassifier`` without a head).

Names are timm's, the ones JAX's ``torch_vit_to_flax`` reads
(``weight_converter.py:127-200``): ``patch_embed.proj``, ``cls_token``,
``reg_token``, ``pos_embed``, ``blocks.i.norm1``, ``blocks.i.attn.qkv``
(packed), ``blocks.i.attn.proj``, ``blocks.i.ls1.gamma``,
``blocks.i.mlp.fc1``/``fc2`` and ``norm``. Layer norms have flax's eps 1e-6.
Attention is ``F.scaled_dot_product_attention`` (flax's
``MultiHeadDotProductAttention`` in JAX, plain XLA ops there too). The
patch embedding pads as flax's ``"SAME"`` conv does, and ``pos_embed`` is
sized for ``img_size`` (224, the input the flax model is initialised at)
and never interpolated.

The wrappers' ``infer_batch`` divides the batch by 255 whatever its dtype
and adds no mean/std normalisation, as JAX's do (:207-210, :235-237), and
the engines' ``infer_batch_device`` does the same (JAX's engines reach
``infer_batch``). Their seeded weights are drawn on the model's device, so
that a full-width encoder is built in well under a second on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.models.architecture.cnn_backbones import SameConv2d, init_backbone_weights
from tiatoolbox_tpu_torch.models.models_abc import ModelABC

_LN_EPS = 1e-6


class _Mlp(nn.Module):
    """fc1, exact GELU (or SwiGLU on a packed fc1), fc2 (:21-35)."""

    def __init__(self, dim: int, hidden: int, swiglu: bool = False) -> None:
        super().__init__()
        self.swiglu = swiglu
        self.fc1 = nn.Linear(dim, 2 * hidden if swiglu else hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.swiglu:
            a, b = h.chunk(2, dim=-1)
            h = F.silu(a) * b
        else:
            h = F.gelu(h)
        return self.fc2(h)


class _Attention(nn.Module):
    """Multi-head self-attention on a packed ``qkv`` projection."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, dim = x.shape
        qkv = self.qkv(x).reshape(n, length, 3, self.num_heads, dim // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(n, length, dim))


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class _Block(nn.Module):
    """Pre-norm block: x + ls1(attn(norm1(x))), then x + ls2(mlp(norm2(x))) (:38-66)."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float, init_values: float | None = None, swiglu: bool = False
    ) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = _Attention(dim, num_heads)
        self.ls1 = nn.Identity() if init_values is None else _LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), swiglu)
        self.ls2 = nn.Identity() if init_values is None else _LayerScale(dim, init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int) -> None:
        super().__init__()
        self.proj = SameConv2d(3, embed_dim, patch_size, patch_size)


class VisionTransformer(nn.Module):
    """ViT tile encoder returning the CLS embedding (or the mean patch token).

    Args:
        patch_size / embed_dim / depth / num_heads / mlp_ratio: ViT widths.
        init_values: Layer-scale init (None: no layer scale).
        reg_tokens: Number of register tokens.
        swiglu: SwiGLU MLPs (Virchow, H0-mini).
        pool: "cls" or "mean".
        img_size: Input size ``pos_embed`` is made for.
    """

    def __init__(
        self,
        patch_size: int = 16,
        embed_dim: int = 1024,
        depth: int = 24,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        init_values: float | None = None,
        reg_tokens: int = 0,
        swiglu: bool = False,
        pool: str = "cls",
        img_size: int = 224,
    ) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.reg_tokens = reg_tokens
        self.pool = pool
        grid = -(-img_size // patch_size)
        self.patch_embed = _PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros(1, reg_tokens, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim))
        self.blocks = nn.Sequential(
            *(_Block(embed_dim, num_heads, mlp_ratio, init_values, swiglu) for _ in range(depth))
        )
        self.norm = nn.LayerNorm(embed_dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input -> ``[N, embed_dim]``."""
        n = x.shape[0]
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        tokens = [self.cls_token.expand(n, -1, -1) + self.pos_embed[:, :1]]
        if self.reg_tokens:
            tokens.append(self.reg_token.expand(n, -1, -1))
        x = torch.cat([*tokens, x + self.pos_embed[:, 1:]], dim=1)
        x = self.norm(self.blocks(x))
        if self.pool == "mean":
            return x[:, 1 + self.reg_tokens :].mean(dim=1)
        return x[:, 0]


def init_vit_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded ViT weights: truncated-normal (std 0.02) linears and patch
    embedding, zero biases, unit layer norms, ``pos_embed`` normal (std
    0.02, flax's initialiser), CLS and register tokens zero (flax's)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, VisionTransformer):
            nn.init.normal_(m.pos_embed, std=0.02, generator=generator)


# Foundation-encoder configs (published architectures; JAX :140-160).
VIT_CONFIGS = {
    "UNI": dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16, init_values=1e-5),
    "UNI2": dict(
        patch_size=14, embed_dim=1536, depth=24, num_heads=24, init_values=1e-5,
        mlp_ratio=2.66667 * 2, reg_tokens=8, swiglu=True,
    ),
    "prov-gigapath": dict(patch_size=16, embed_dim=1536, depth=40, num_heads=24, init_values=1e-5),
    "H-optimus-0": dict(patch_size=14, embed_dim=1536, depth=40, num_heads=24, init_values=1e-5, reg_tokens=4),
    "H-optimus-1": dict(patch_size=14, embed_dim=1536, depth=40, num_heads=24, init_values=1e-5, reg_tokens=4),
    "H0-mini": dict(
        patch_size=14, embed_dim=768, depth=12, num_heads=12, init_values=1e-5, swiglu=True, reg_tokens=4
    ),
    "Virchow": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16, swiglu=True),
    "Virchow2": dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16, swiglu=True, reg_tokens=4),
    "kaiko": dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16, reg_tokens=4),
}


def _encoder(backbone: str) -> tuple[nn.Module, int]:
    """The tile encoder of a ``VIT_CONFIGS`` name (``pos_embed`` for 224^2,
    as the JAX wrappers initialise it) or "efficientnet_b*", and its width."""
    if backbone in VIT_CONFIGS:
        cfg = VIT_CONFIGS[backbone]
        return VisionTransformer(**cfg), cfg["embed_dim"]
    if backbone.startswith("efficientnet"):
        from tiatoolbox_tpu_torch.models.architecture.efficientnet import (
            EFFICIENTNET_PARAMS,
            EfficientNetClassifier,
        )

        if backbone in EFFICIENTNET_PARAMS:
            encoder = EfficientNetClassifier(variant=backbone, num_classes=0)
            return encoder, encoder.num_features
    msg = f"Backbone {backbone!r} not supported."
    raise ValueError(msg)


class TimmBackbone(ModelABC):
    """Foundation tile-encoder wrapper (``feat_extract``): NHWC -> embeddings.

    Args:
        backbone: A ``VIT_CONFIGS`` name (UNI, UNI2, prov-gigapath,
            H-optimus-0/1, H0-mini, Virchow, Virchow2, kaiko) or
            "efficientnet_b{0..7}".
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator``, on the model's device, that
            the weights are drawn from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        backbone: str,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(compute_dtype)
        self.backbone = backbone
        dev = resolve_device(device)
        with torch.device(dev):
            self.feat_extract, self.num_features = _encoder(backbone)
            self._build_head()
        generator = torch.Generator(dev).manual_seed(seed)
        if isinstance(self.feat_extract, VisionTransformer):
            init_vit_weights(self, generator)
        else:
            init_backbone_weights(self, generator)
        self.place(dev)

    def _build_head(self) -> None:
        """Layers after the encoder (none for a feature extractor)."""

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch -> ``[N, num_features]``."""
        return self.feat_extract(batch)

    @classmethod
    def infer_batch_device(cls, model: "TimmBackbone", batch_data, device=None):
        """NHWC batch (any dtype) -> cast -> /255 -> ``forward``, on the device."""
        if device is not None:
            model.to(resolve_device(device))
        batch = model.stage_batch(batch_data)
        with torch.inference_mode():
            return model(batch.to(model.compute_dtype) / 255.0)


class TimmModel(TimmBackbone):
    """Patch classifier over a foundation tile encoder: encoder, linear
    ``classifier``, float32 softmax in ``infer_batch_device``.

    Args:
        backbone: As for ``TimmBackbone``.
        num_classes: Classifier output width.
        **kwargs: ``TimmBackbone``'s ``compute_dtype``, ``seed`` and ``device``.
    """

    def __init__(self, backbone: str, num_classes: int = 1, **kwargs) -> None:
        self.num_classes = num_classes
        super().__init__(backbone, **kwargs)

    def _build_head(self) -> None:
        self.classifier = nn.Linear(self.num_features, self.num_classes)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC float batch -> logits ``[N, num_classes]``."""
        return self.classifier(self.feat_extract(batch))

    @classmethod
    def infer_batch_device(cls, model: "TimmModel", batch_data, device=None):
        """NHWC batch -> float32 softmax probabilities on the device."""
        return torch.softmax(super().infer_batch_device(model, batch_data, device).float(), dim=-1)

