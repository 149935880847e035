"""SAM's random Fourier positional embedding and its prompt encoder.

Counterparts of ``transformers.models.sam.modeling_sam`` (4.57) under its
parameter names (``prompt_encoder.*``, ``shared_image_embedding.*``):

- ``SamPositionalEmbedding`` (:550): coordinates divided by the input size
  (in the coordinates' dtype: float64 for the processor's prompts), mapped
  to [-1, 1], cast to float32, times the ``positional_embedding`` matrix
  (a random Fourier basis read from the checkpoint, never drawn again),
  times 2 pi, then sin and cos;
- points (``_embed_points`` :617): shifted by +0.5 to the pixel centres;
  without a box one padding point labelled -1 is appended; label -1 takes
  ``not_a_point_embed``, -10 (the processor's padding) zeros, 0 and 1 add
  ``point_embed[0]`` and ``[1]``;
- boxes (``_embed_boxes`` :651): the two corners, shifted by +0.5, plus
  ``point_embed[2]`` and ``[3]``;
- the dense embedding is ``no_mask_embed`` over the image-embedding grid
  (:698).

The ``mask_embed`` parameters are kept so that a checkpoint loads
strictly, but the mask-prompt path (``input_masks``) is not ported: JAX's
wrapper never passes a mask (``sam.py:63-68``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tiatoolbox_tpu_torch.models.architecture.sam_config import SamConfig
from tiatoolbox_tpu_torch.models.architecture.sam_vision import SamLayerNorm2d


class SamPositionalEmbedding(nn.Module):
    """Random Fourier features of 2-D coordinates (:550)."""

    def __init__(self, num_pos_feats: int) -> None:
        super().__init__()
        self.register_buffer("positional_embedding", torch.zeros(2, num_pos_feats))

    def forward(self, coords: torch.Tensor, input_shape: tuple[int, int] | None = None) -> torch.Tensor:
        coordinates = coords.clone()
        if input_shape is not None:
            coordinates[..., 0] = coordinates[..., 0] / input_shape[1]
            coordinates[..., 1] = coordinates[..., 1] / input_shape[0]
        coordinates = 2 * coordinates - 1
        coordinates = coordinates.to(self.positional_embedding.dtype) @ self.positional_embedding
        coordinates = 2 * math.pi * coordinates
        return torch.cat([torch.sin(coordinates), torch.cos(coordinates)], dim=-1)


class SamMaskEmbedding(nn.Module):
    """The mask-prompt embedding's parameters (:573); its forward is not ported."""

    def __init__(self, hidden_size: int, mask_input_channels: int, eps: float) -> None:
        super().__init__()
        quarter = mask_input_channels // 4
        self.conv1 = nn.Conv2d(1, quarter, kernel_size=2, stride=2)
        self.conv2 = nn.Conv2d(quarter, mask_input_channels, kernel_size=2, stride=2)
        self.conv3 = nn.Conv2d(mask_input_channels, hidden_size, kernel_size=1)
        self.layer_norm1 = SamLayerNorm2d(quarter, eps=eps)
        self.layer_norm2 = SamLayerNorm2d(mask_input_channels, eps=eps)


class SamPromptEncoder(nn.Module):
    """Points and boxes -> sparse embeddings; the dense no-mask embedding (:600).

    ``shared_embedding`` is the model's ``shared_image_embedding`` module
    (transformers ties the two, ``SamModel._tie_weights`` :1130).
    """

    def __init__(self, config: SamConfig, shared_embedding: SamPositionalEmbedding) -> None:
        super().__init__()
        prompt = config.prompt_encoder_config
        self.shared_embedding = shared_embedding
        self.mask_embed = SamMaskEmbedding(prompt.hidden_size, prompt.mask_input_channels, prompt.layer_norm_eps)
        self.no_mask_embed = nn.Embedding(1, prompt.hidden_size)
        self.image_embedding_size = prompt.image_embedding_size
        self.input_image_size = prompt.image_size
        self.point_embed = nn.ModuleList(nn.Embedding(1, prompt.hidden_size) for _ in range(prompt.num_point_embeddings))
        self.not_a_point_embed = nn.Embedding(1, prompt.hidden_size)

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor, pad: bool) -> torch.Tensor:
        points = points + 0.5
        if pad:
            b, p = points.shape[:2]
            points = torch.cat([points, torch.zeros((b, p, 1, 2), device=points.device)], dim=2)
            labels = torch.cat([labels, -torch.ones((b, p, 1), device=labels.device)], dim=2)
        size = (self.input_image_size, self.input_image_size)
        emb = self.shared_embedding(points, size)
        labels = labels[..., None]
        emb = torch.where(labels == -1, self.not_a_point_embed.weight, emb)
        emb = torch.where(labels != -10, emb, torch.zeros_like(emb))
        emb = torch.where(labels == 0, emb + self.point_embed[0].weight[None, None], emb)
        return torch.where(labels == 1, emb + self.point_embed[1].weight[None, None], emb)

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        boxes = boxes + 0.5
        b, n = boxes.shape[:2]
        size = (self.input_image_size, self.input_image_size)
        corners = self.shared_embedding(boxes.reshape(b, n, 2, 2), size)
        corners[:, :, 0, :] += self.point_embed[2].weight
        corners[:, :, 1, :] += self.point_embed[3].weight
        return corners

    def forward(
        self, input_points: torch.Tensor | None, input_labels: torch.Tensor | None, input_boxes: torch.Tensor | None
    ) -> tuple[torch.Tensor | None, torch.Tensor]:
        """Sparse [B, P, T, C] (or None) and dense [B, C, E, E] embeddings."""
        sparse, batch = None, 1
        if input_points is not None:
            batch = input_points.shape[0]
            sparse = self._embed_points(input_points, input_labels, pad=input_boxes is None)
        if input_boxes is not None:
            batch = input_boxes.shape[0]
            boxes = self._embed_boxes(input_boxes)
            sparse = boxes if sparse is None else torch.cat([sparse, boxes], dim=2)
        e = self.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(batch, -1, e, e)
        return sparse, dense
