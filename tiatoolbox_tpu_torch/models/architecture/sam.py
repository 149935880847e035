"""Segment Anything: ``SamNet`` (``transformers.SamModel``'s forward and names) and ``SAM``.

Counterpart of ``tiatoolbox_tpu/models/architecture/sam.py``, which wraps
``transformers.SamModel`` and ``SamProcessor`` (:31-32). The card machine
has neither transformers nor PIL, so the port has its own network
(``sam_vision``, ``sam_prompt``, ``sam_decoder``), processor
(``sam_processor``) and checkpoint reader (``weight_converter.
load_sam_checkpoint`` over ``utils/safetensors_lite.py``), under
transformers' parameter names: a checkpoint directory (``config.json``,
``model.safetensors`` or ``pytorch_model.bin``, ``preprocessor_config.json``)
as transformers 4.57's ``save_pretrained`` writes it loads strictly.

``SamNet.forward`` is ``SamModel.forward`` (``modeling_sam.py:1202``)
without the mask prompt: the image-wide positional embedding (:1138), the
image encoder (or given image embeddings), the prompt encoder (labels
default to ones, :1331) and the mask decoder, which returns masks 1:4, as
``SamModel.forward``'s default ``multimask_output=True`` does.

``SAM(checkpoint_path)`` takes a local directory, or a hub id such as
``facebook/sam-vit-base``, resolved offline to ``snapshots/*/`` under
``HF_HUB_CACHE``, else ``HF_HOME/hub``, else
``~/.cache/huggingface/hub`` (``models--facebook--sam-vit-base``); a
checkpoint that is not there raises ``FileNotFoundError`` with JAX's
message (:33-39). ``infer_batch`` returns what JAX's returns (:42-78):
per image, the first prompt batch's masks (``masks[0][0]``, :78) as bool
``[3, H, W]``. The port takes ``box_coords[i]`` as nested lists or as a
numpy array (JAX's processor refuses the array, ``processing_sam.py:276``);
both give the same masks. The image encoder takes up to ``ENCODER_BATCH``
images of a call at once; the prompts are decoded image by image, as JAX's
loop does.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from tiatoolbox_tpu_torch import logger, resolve_device
from tiatoolbox_tpu_torch.models.architecture.sam_config import (
    PreprocessorConfig,
    SamConfig,
    read_preprocessor_config,
)
from tiatoolbox_tpu_torch.models.architecture.sam_decoder import SamMaskDecoder
from tiatoolbox_tpu_torch.models.architecture.sam_processor import (
    post_process_masks,
    preprocess,
    scale_boxes,
    scale_points,
)
from tiatoolbox_tpu_torch.models.architecture.sam_prompt import SamPositionalEmbedding, SamPromptEncoder
from tiatoolbox_tpu_torch.models.architecture.sam_vision import SamVisionEncoder
from tiatoolbox_tpu_torch.utils.safetensors_lite import save_safetensors

ENCODER_BATCH = 4  # images through the image encoder at once (a 7.4 GB peak at ViT-B in float32)


class SamNet(nn.Module):
    """``SamModel`` (``modeling_sam.py:1112``) without the mask prompt."""

    def __init__(self, config: SamConfig | None = None) -> None:
        super().__init__()
        self.config = config = config or SamConfig()
        self.shared_image_embedding = SamPositionalEmbedding(config.vision_config.num_pos_feats)
        self.vision_encoder = SamVisionEncoder(config.vision_config)
        self.prompt_encoder = SamPromptEncoder(config, self.shared_image_embedding)
        self.mask_decoder = SamMaskDecoder(config.mask_decoder_config)

    def get_image_wide_positional_embeddings(self) -> torch.Tensor:
        """[1, C, E, E] embedding of the image-embedding grid's cell centres (:1138)."""
        size = self.config.prompt_encoder_config.image_embedding_size
        pe = self.shared_image_embedding.positional_embedding
        grid = torch.ones((size, size), device=pe.device, dtype=pe.dtype)
        y = (grid.cumsum(dim=0) - 0.5) / size
        x = (grid.cumsum(dim=1) - 0.5) / size
        return self.shared_image_embedding(torch.stack([x, y], dim=-1)).permute(2, 0, 1).unsqueeze(0)

    def forward(
        self,
        pixel_values: torch.Tensor | None = None,
        input_points: torch.Tensor | None = None,
        input_labels: torch.Tensor | None = None,
        input_boxes: torch.Tensor | None = None,
        image_embeddings: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Low-resolution mask logits [B, P, 3, 4E, 4E] and IoU scores [B, P, 3].

        ``input_points`` is [B, P, N, 2] and ``input_boxes`` [B, P, 4] in the
        resized image's pixels (``SamModel.forward``'s shapes).
        """
        if (pixel_values is None) == (image_embeddings is None):
            msg = "Give exactly one of pixel_values and image_embeddings."
            raise ValueError(msg)
        if input_points is not None and input_points.dim() != 4:
            msg = f"input_points must be [B, P, N, 2], not {tuple(input_points.shape)}."
            raise ValueError(msg)
        if input_boxes is not None and input_boxes.dim() != 3:
            msg = f"input_boxes must be [B, P, 4], not {tuple(input_boxes.shape)}."
            raise ValueError(msg)
        if input_points is not None and input_boxes is not None and input_points.shape[1] != input_boxes.shape[1]:
            msg = (
                "You should provide as many bounding boxes as input points per box. "
                f"Got {input_points.shape[1]} and {input_boxes.shape[1]}."
            )
            raise ValueError(msg)
        if pixel_values is not None:
            image_embeddings = self.vision_encoder(pixel_values)
        image_pe = self.get_image_wide_positional_embeddings().repeat(image_embeddings.shape[0], 1, 1, 1)
        if input_points is not None and input_labels is None:
            input_labels = torch.ones_like(input_points[:, :, :, 0], dtype=torch.int)
        sparse, dense = self.prompt_encoder(input_points, input_labels, input_boxes)
        return self.mask_decoder(image_embeddings, image_pe, sparse, dense)


def build_sam_net(
    config: SamConfig, state: dict[str, torch.Tensor], device: str | torch.device | None = None
) -> SamNet:
    """A ``SamNet`` holding ``state`` (loaded strictly: every name, no other)
    on ``resolve_device(device)``, in eval mode."""
    with torch.device(resolve_device(device)):
        net = SamNet(config)
    net.load_state_dict(state, strict=True)
    return net.eval()


def _hub_cache() -> Path:
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    return Path.home() / ".cache" / "huggingface" / "hub"


def resolve_checkpoint(checkpoint_path: str | Path) -> Path | None:
    """A local checkpoint directory, or a hub id's snapshot in the local cache
    (the one ``refs/main`` names, else the newest holding a ``config.json``)."""
    path = Path(checkpoint_path).expanduser()
    if path.is_dir():
        return path
    if path.is_absolute() or str(checkpoint_path).count("/") != 1:
        return None
    repo = _hub_cache() / ("models--" + str(checkpoint_path).replace("/", "--"))
    ref = repo / "refs" / "main"
    if ref.is_file() and (repo / "snapshots" / ref.read_text().strip() / "config.json").is_file():
        return repo / "snapshots" / ref.read_text().strip()
    snapshots = sorted(
        (p for p in (repo / "snapshots").glob("*") if (p / "config.json").is_file()),
        key=lambda p: p.stat().st_mtime,
    )
    return snapshots[-1] if snapshots else None


def save_sam_checkpoint(
    directory: str | Path,
    state: dict[str, np.ndarray],
    config: SamConfig | None = None,
    preprocessor: PreprocessorConfig | None = None,
) -> Path:
    """Write ``config.json``, ``model.safetensors`` (float32, the tied
    prompt-encoder embedding left out, as ``save_pretrained`` does) and
    ``preprocessor_config.json``: a directory ``SAM`` and transformers load."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps((config or SamConfig()).to_json_dict(), indent=2))
    (directory / "preprocessor_config.json").write_text(
        json.dumps((preprocessor or PreprocessorConfig()).to_json_dict(), indent=2)
    )
    weights = {
        k: np.asarray(v, dtype=np.float32) for k, v in state.items() if k != "prompt_encoder.shared_embedding.positional_embedding"
    }
    save_safetensors(weights, directory / "model.safetensors")
    return directory


class SAM:
    """Prompt-based segmentation with Segment Anything.

    Args:
        checkpoint_path: Local directory or hub id of the SAM checkpoint
            (default "facebook/sam-vit-base"), read offline.
        device: Where the network runs (``rcParam["device"]`` by default).
    """

    def __init__(self, checkpoint_path: str | Path = "facebook/sam-vit-base", device=None) -> None:
        from tiatoolbox_tpu_torch.models.architecture.weight_converter import load_sam_checkpoint

        directory = resolve_checkpoint(checkpoint_path)
        try:
            if directory is None:
                raise FileNotFoundError(checkpoint_path)
            net = load_sam_checkpoint(directory, device=device)
            preprocessor = read_preprocessor_config(directory)
        except OSError as exc:
            msg = (
                f"Could not load SAM checkpoint {str(checkpoint_path)!r}. This "
                "environment is zero-egress: place the checkpoint in the "
                "local HF cache or pass a local path."
            )
            raise FileNotFoundError(msg) from exc
        self.model = net
        self.preprocessor = preprocessor
        logger.info("Loaded SAM checkpoint %s", checkpoint_path)

    @property
    def device(self) -> torch.device:
        return self.model.shared_image_embedding.positional_embedding.device

    def to(self, device=None) -> SAM:
        """Move the network to ``resolve_device(device)``."""
        self.model.to(resolve_device(device))
        return self

    def encode(self, images) -> tuple[torch.Tensor, list[tuple[int, int]], list[tuple[int, int]]]:
        """Image embeddings [N, C, E, E] of uint8 [H, W, 3] images, with each
        image's original and resized (h, w)."""
        prepared = [preprocess(image, self.preprocessor, self.device) for image in images]
        pixels = torch.stack([p[0] for p in prepared])
        with torch.inference_mode():
            embeddings = torch.cat(
                [self.model.vision_encoder(pixels[i : i + ENCODER_BATCH]) for i in range(0, len(pixels), ENCODER_BATCH)]
            )
        return embeddings, [p[1] for p in prepared], [p[2] for p in prepared]

    def prompt_tensors(self, points, boxes, original: tuple[int, int]) -> dict[str, torch.Tensor]:
        """One image's prompts as ``SamProcessor`` gives them to the model:
        points [1, 1, N, 2] and boxes [1, P, 4], float64, in the resized image."""
        out = {}
        edge = self.preprocessor.longest_edge
        if points is not None:
            out["input_points"] = torch.from_numpy(scale_points(points, original, edge)[None, None]).to(self.device)
        if boxes is not None:
            out["input_boxes"] = torch.from_numpy(scale_boxes(boxes, original, edge)[None]).to(self.device)
        return out

    def infer_logits(self, images, point_coords=None, box_coords=None) -> list[dict]:
        """Per image: the low-resolution mask logits [P, 3, 4E, 4E], the IoU
        scores [P, 3] (P prompt batches) and the original and resized (h, w)."""
        embeddings, originals, resized = self.encode(images)
        out = []
        for i in range(len(originals)):
            prompts = self.prompt_tensors(
                point_coords[i] if point_coords is not None else None,
                box_coords[i] if box_coords is not None else None,
                originals[i],
            )
            with torch.inference_mode():
                masks, iou = self.model(image_embeddings=embeddings[i : i + 1], **prompts)
            out.append(
                {"low_res_masks": masks[0], "iou_scores": iou[0], "original_size": originals[i], "reshaped_size": resized[i]}
            )
        return out

    def infer_batch(self, images, point_coords=None, box_coords=None) -> list[np.ndarray]:
        """Segment each image given point and/or box prompts.

        Args:
            images: uint8 NHWC batch (or a list of HWC images).
            point_coords: Per-image point prompts [[x, y], ...].
            box_coords: Per-image box prompts: [x0, y0, x1, y1], nested
                lists or an array of boxes.

        Returns:
            List of bool masks [3, H, W] per image (the first prompt batch).
        """
        out = []
        for result in self.infer_logits(images, point_coords, box_coords):
            masks = post_process_masks(
                result["low_res_masks"][:1], result["original_size"], result["reshaped_size"], self.preprocessor
            )
            out.append(masks[0].cpu().numpy())
        return out


def seeded_sam_state(config: SamConfig | None = None, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded float32 weights for every state-dict name of ``SamNet(config)``:
    linear and conv weights at variance 1/fan_in, LayerNorm weights near 1,
    biases, ``pos_embed`` and relative positions small, embedding tables at
    unit variance and the Fourier matrix at scale 1 (the original SAM's
    ``PositionEmbeddingRandom``; transformers' own init draws it at
    ``hidden_size // 2``, but checkpoints carry the original's)."""
    net = SamNet(config or SamConfig())
    rng = np.random.default_rng(seed)
    state = {}
    for prefix, module in net.named_modules(remove_duplicate=False):
        for leaf, tensor in [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]:
            shape = tuple(tensor.shape)
            if leaf == "positional_embedding" or isinstance(module, nn.Embedding):
                value = rng.standard_normal(shape)
            elif leaf in ("bias", "pos_embed", "rel_pos_h", "rel_pos_w"):
                value = 0.02 * rng.standard_normal(shape)
            elif isinstance(module, nn.LayerNorm):
                value = 1.0 + 0.1 * rng.standard_normal(shape)
            else:  # Linear, Conv2d [out, in, ...], ConvTranspose2d [in, out, ...]
                fan_in = shape[0] if isinstance(module, nn.ConvTranspose2d) else math.prod(shape[1:])
                value = rng.standard_normal(shape) / math.sqrt(fan_in)
            state[f"{prefix}.{leaf}" if prefix else leaf] = value.astype(np.float32)
    state["prompt_encoder.shared_embedding.positional_embedding"] = state["shared_image_embedding.positional_embedding"]
    return state
