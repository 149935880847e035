"""SAM's image encoder: a ViT with windowed and global attention and a conv neck.

Counterpart of ``transformers.models.sam.modeling_sam`` (4.57), which JAX's
``SAM`` runs (``tiatoolbox_tpu/models/architecture/sam.py:31``), under its
parameter names (``vision_encoder.*``):

- ``patch_embed.projection``: a 16x16 convolution of stride 16
  (``SamPatchEmbeddings`` :101), then the absolute ``pos_embed`` (:1070);
- ``layers.i`` (``SamVisionLayer`` :902): ``layer_norm1``, then, in a
  windowed layer, the tokens padded with zeros to a multiple of the window
  and cut into windows (``window_partition`` :911; the padded tokens take
  part in the attention, as in the reference), attention, the windows put
  back and the padding removed (:935), the residual, ``layer_norm2`` and
  the MLP (``lin1``, exact GELU, ``lin2``);
- ``attn`` (``SamVisionSdpaAttention`` :838, the implementation
  transformers picks by default): packed ``qkv``, the decomposed relative
  position (``get_rel_pos`` :733: ``rel_pos`` interpolated linearly where
  its length is not ``2 size - 1``; ``get_decomposed_rel_pos`` :765, from
  the unscaled query) as the additive mask of
  ``F.scaled_dot_product_attention`` (``softmax(q k^T d^-1/2 + bias) v``),
  then ``proj``. On the H100 this was 9 % faster than the eager
  ``SamVisionAttention`` (:807) and a third lighter at batch 4, with the
  same embeddings within 1.1e-5 (PERF.md);
- ``neck`` (``SamVisionNeck`` :986): a 1x1 convolution, a channels-first
  LayerNorm of eps 1e-6 (``SamLayerNorm`` :151), a 3x3 convolution, the
  LayerNorm again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.sam_config import SamVisionConfig


class SamLayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map (``SamLayerNorm`` :151, channels_first)."""

    def __init__(self, channels: int, eps: float = 1e-6) -> None:
        super().__init__(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SamMLPBlock(nn.Module):
    """``lin1``, the activation, ``lin2`` (``SamMLPBlock`` :136)."""

    def __init__(self, width: int, hidden: int, act: str) -> None:
        super().__init__()
        self.lin1 = nn.Linear(width, hidden)
        self.lin2 = nn.Linear(hidden, width)
        self.act = nn.GELU() if act == "gelu" else nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative position embeddings of each (query, key) pair (:733)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1), size=max_rel_dist, mode="linear")
        rel_pos = rel_pos.reshape(-1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative_coords.long()]


class SamVisionAttention(nn.Module):
    """Multi-head attention with decomposed relative positions (:705)."""

    def __init__(self, config: SamVisionConfig, window_size: int) -> None:
        super().__init__()
        size = config.grid if window_size == 0 else window_size
        self.num_attention_heads = config.num_attention_heads
        head_dim = config.hidden_size // config.num_attention_heads
        self.qkv = nn.Linear(config.hidden_size, config.hidden_size * 3)
        self.proj = nn.Linear(config.hidden_size, config.hidden_size)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, height, width, _ = x.shape
        heads = self.num_attention_heads
        qkv = self.qkv(x).reshape(batch, height * width, 3, heads, -1).permute(2, 0, 3, 1, 4)
        query, key, value = qkv.reshape(3, batch * heads, height * width, -1).unbind(0)
        rel_h = get_rel_pos(height, height, self.rel_pos_h)
        rel_w = get_rel_pos(width, width, self.rel_pos_w)
        q = query.reshape(batch * heads, height, width, -1)
        bias_h = torch.einsum("bhwc,hkc->bhwk", q, rel_h)
        bias_w = torch.einsum("bhwc,wkc->bhwk", q, rel_w)
        bias = (bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]).reshape(batch, heads, height * width, -1)
        shape = (batch, heads, height * width, -1)
        out = F.scaled_dot_product_attention(query.view(shape), key.view(shape), value.view(shape), attn_mask=bias)
        return self.proj(out.view(batch, heads, height, width, -1).permute(0, 2, 3, 1, 4).reshape(batch, height, width, -1))


def window_partition(x: torch.Tensor, window: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """Zero-pad [B, H, W, C] to multiples of ``window`` and cut it into windows (:911)."""
    batch, height, width, channels = x.shape
    pad_h = (window - height % window) % window
    pad_w = (window - width % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = height + pad_h, width + pad_w
    x = x.reshape(batch, ph // window, window, pw // window, window, channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, channels), (ph, pw)


def window_unpartition(windows: torch.Tensor, window: int, padded: tuple[int, int], size: tuple[int, int]) -> torch.Tensor:
    """Put windows back into [B, H, W, C] and remove the padding (:935)."""
    ph, pw = padded
    batch = windows.shape[0] // (ph * pw // window // window)
    x = windows.reshape(batch, ph // window, pw // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(batch, ph, pw, -1)
    return x[:, : size[0], : size[1], :]


class SamVisionLayer(nn.Module):
    """A pre-norm transformer block, windowed when ``window_size`` > 0 (:902)."""

    def __init__(self, config: SamVisionConfig, window_size: int) -> None:
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.attn = SamVisionAttention(config, window_size)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.mlp = SamMLPBlock(config.hidden_size, config.mlp_dim, "gelu")
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm1(x)
        if self.window_size > 0:
            size = (h.shape[1], h.shape[2])
            h, padded = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, padded, size)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.layer_norm2(x))


class SamVisionNeck(nn.Module):
    """1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d (:986)."""

    def __init__(self, config: SamVisionConfig) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(config.hidden_size, config.output_channels, kernel_size=1, bias=False)
        self.layer_norm1 = SamLayerNorm2d(config.output_channels)
        self.conv2 = nn.Conv2d(config.output_channels, config.output_channels, kernel_size=3, padding=1, bias=False)
        self.layer_norm2 = SamLayerNorm2d(config.output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm1(self.conv1(x.permute(0, 3, 1, 2)))
        return self.layer_norm2(self.conv2(x))


class SamVisionEncoder(nn.Module):
    """[B, 3, S, S] normalised pixels -> [B, output_channels, S/16, S/16] (:1026)."""

    def __init__(self, config: SamVisionConfig) -> None:
        super().__init__()
        self.config = config
        self.patch_embed = nn.Module()
        self.patch_embed.projection = nn.Conv2d(
            config.num_channels, config.hidden_size, kernel_size=config.patch_size, stride=config.patch_size
        )
        self.pos_embed = nn.Parameter(torch.zeros(1, config.grid, config.grid, config.hidden_size))
        self.layers = nn.ModuleList(
            SamVisionLayer(config, 0 if i in config.global_attn_indexes else config.window_size)
            for i in range(config.num_hidden_layers)
        )
        self.neck = SamVisionNeck(config)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        size = self.config.image_size
        if pixel_values.shape[1:] != (self.config.num_channels, size, size):
            msg = f"SAM's image encoder takes [B, {self.config.num_channels}, {size}, {size}], not {tuple(pixel_values.shape)}."
            raise ValueError(msg)
        x = self.patch_embed.projection(pixel_values).permute(0, 2, 3, 1) + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)
