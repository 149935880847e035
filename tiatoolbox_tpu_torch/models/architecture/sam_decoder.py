"""SAM's mask decoder: the two-way transformer, the upscaling and the heads.

Counterparts of ``transformers.models.sam.modeling_sam`` (4.57) under its
parameter names (``mask_decoder.*``):

- ``SamAttention`` (:199): ``q_proj``/``k_proj``/``v_proj`` into
  ``hidden / downsample_rate`` channels (2 for the cross-attentions, 1 for
  the tokens' self-attention), heads, ``softmax(q k^T * d^-1/2) v`` in
  float32, ``out_proj``;
- ``SamTwoWayAttentionBlock`` (:277): token self-attention (the first
  layer without the positional embedding), tokens to image, an MLP with
  ReLU, image to tokens, each followed by its LayerNorm (eps 1e-6);
- ``SamTwoWayTransformer`` (:355): the blocks, a final tokens-to-image
  attention and ``layer_norm_final_attn`` (eps 1e-5, PyTorch's default);
- ``SamMaskDecoder`` (:436): the IoU and mask tokens before the prompt's
  sparse embeddings, the image embedding plus the dense one, two
  ``ConvTranspose2d`` (x4 in all) with a channels-first LayerNorm and exact
  GELU, one hypernetwork MLP per mask token (``SamFeedForward`` :412,
  ReLU), the masks as their product with the upscaled embedding, and the
  IoU head; masks 1:4 are kept, as ``multimask_output=True`` (``SamModel.forward``'s
  default, the one JAX's wrapper uses) keeps them (:541).
"""

from __future__ import annotations

import torch
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.sam_config import SamMaskDecoderConfig
from tiatoolbox_tpu_torch.models.architecture.sam_vision import SamLayerNorm2d, SamMLPBlock


class SamAttention(nn.Module):
    """Attention whose projections may shrink the width by ``downsample_rate`` (:199)."""

    def __init__(self, config: SamMaskDecoderConfig, downsample_rate: int | None = None) -> None:
        super().__init__()
        rate = config.attention_downsample_rate if downsample_rate is None else downsample_rate
        internal = config.hidden_size // rate
        if internal % config.num_attention_heads:
            msg = "num_attention_heads must divide hidden_size."
            raise ValueError(msg)
        self.num_attention_heads = config.num_attention_heads
        self.scaling = (internal // config.num_attention_heads) ** -0.5
        self.q_proj = nn.Linear(config.hidden_size, internal)
        self.k_proj = nn.Linear(config.hidden_size, internal)
        self.v_proj = nn.Linear(config.hidden_size, internal)
        self.out_proj = nn.Linear(internal, config.hidden_size)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, p, t, c = x.shape
        return x.reshape(b * p, t, self.num_attention_heads, c // self.num_attention_heads).transpose(1, 2)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        b, p, t = query.shape[:3]
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        weights = torch.softmax(torch.matmul(q, k.transpose(2, 3)) * self.scaling, dim=-1, dtype=torch.float32)
        out = torch.matmul(weights.to(q.dtype), v).transpose(1, 2)
        return self.out_proj(out.reshape(b, p, t, -1))


class SamTwoWayAttentionBlock(nn.Module):
    """Sparse self-attention, sparse -> dense, MLP, dense -> sparse (:277)."""

    def __init__(self, config: SamMaskDecoderConfig, skip_first_layer_pe: bool) -> None:
        super().__init__()
        width, eps = config.hidden_size, config.layer_norm_eps
        self.self_attn = SamAttention(config, downsample_rate=1)
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.cross_attn_token_to_image = SamAttention(config)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)
        self.mlp = SamMLPBlock(width, config.mlp_dim, "relu")
        self.layer_norm3 = nn.LayerNorm(width, eps=eps)
        self.layer_norm4 = nn.LayerNorm(width, eps=eps)
        self.cross_attn_image_to_token = SamAttention(config)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe) -> tuple[torch.Tensor, torch.Tensor]:
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            query = queries + query_pe
            queries = queries + self.self_attn(query, query, queries)
        queries = self.layer_norm1(queries)
        key = keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(queries + query_pe, key, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))
        attn = self.cross_attn_image_to_token(keys + key_pe, queries + query_pe, queries)
        return queries, self.layer_norm4(keys + attn)


class SamTwoWayTransformer(nn.Module):
    """The two-way blocks and a final tokens -> image attention (:355)."""

    def __init__(self, config: SamMaskDecoderConfig) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            SamTwoWayAttentionBlock(config, skip_first_layer_pe=i == 0) for i in range(config.num_hidden_layers)
        )
        self.final_attn_token_to_image = SamAttention(config)
        self.layer_norm_final_attn = nn.LayerNorm(config.hidden_size)

    def forward(self, point_embeddings, image_embeddings, image_pe) -> tuple[torch.Tensor, torch.Tensor]:
        keys = image_embeddings.flatten(2).permute(0, 2, 1).unsqueeze(1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1).unsqueeze(1)
        queries = point_embeddings
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embeddings, key_pe)
        attn = self.final_attn_token_to_image(queries + point_embeddings, keys + key_pe, keys)
        return self.layer_norm_final_attn(queries + attn), keys


class SamFeedForward(nn.Module):
    """``proj_in``, ``layers``, ``proj_out`` with ReLU between (:412)."""

    def __init__(self, width: int, hidden: int, out: int, num_layers: int) -> None:
        super().__init__()
        self.proj_in = nn.Linear(width, hidden)
        self.proj_out = nn.Linear(hidden, out)
        self.layers = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(num_layers - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.proj_in(x))
        for layer in self.layers:
            x = torch.relu(layer(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    """Image and prompt embeddings -> low-resolution mask logits and IoU scores (:436)."""

    def __init__(self, config: SamMaskDecoderConfig) -> None:
        super().__init__()
        width = config.hidden_size
        self.num_mask_tokens = config.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, width)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, width)
        self.transformer = SamTwoWayTransformer(config)
        self.upscale_conv1 = nn.ConvTranspose2d(width, width // 4, kernel_size=2, stride=2)
        self.upscale_conv2 = nn.ConvTranspose2d(width // 4, width // 8, kernel_size=2, stride=2)
        self.upscale_layer_norm = SamLayerNorm2d(width // 4)
        self.activation = nn.GELU()
        self.output_hypernetworks_mlps = nn.ModuleList(
            SamFeedForward(width, width, width // 8, 3) for _ in range(self.num_mask_tokens)
        )
        self.iou_prediction_head = SamFeedForward(
            width, config.iou_head_hidden_dim, self.num_mask_tokens, config.iou_head_depth
        )

    def forward(self, image_embeddings, image_pe, sparse, dense) -> tuple[torch.Tensor, torch.Tensor]:
        """Masks [B, P, 3, 4E, 4E] and IoU scores [B, P, 3] (the multimask outputs)."""
        batch, channels, height, width = image_embeddings.shape
        points = sparse.shape[1] if sparse is not None else 1
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0).repeat(batch, points, 1, 1)
        if sparse is not None:
            tokens = torch.cat((tokens, sparse), dim=2)
        tokens = tokens.to(self.iou_token.weight.dtype)
        image = (image_embeddings + dense).repeat_interleave(points, 0)
        image_pe = image_pe.repeat_interleave(points, 0)
        out_tokens, image = self.transformer(tokens, image, image_pe)
        iou_token = out_tokens[:, :, 0, :]
        mask_tokens = out_tokens[:, :, 1 : 1 + self.num_mask_tokens, :]
        image = image.transpose(2, 3).reshape(batch * points, channels, height, width)
        up = self.activation(self.upscale_layer_norm(self.upscale_conv1(image)))
        up = self.activation(self.upscale_conv2(up))
        hyper = torch.stack([mlp(mask_tokens[:, :, i, :]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=2)
        _, c, h, w = up.shape
        masks = (hyper @ up.reshape(batch, points, c, h * w)).reshape(batch, points, -1, h, w)
        iou = self.iou_prediction_head(iou_token)
        return masks[:, :, 1:], iou[:, :, 1:]
