"""Interactive prompt-based segmentation engine.

Counterpart of ``tiatoolbox_tpu/models/engine/prompt_segmentor.py`` (:19-88):
runs the SAM wrapper on interactively selected tiles with point and box
prompts, unions each tile's masks over their leading axes, and writes one
annotation store per tile through ``dict_to_store_semantic_segmentor``
with the engine's ``scale`` and ``offset`` (:68-80). ``calc_mpp`` (:82-88)
sets the scale for a large interactive area. The SAM network runs on
``resolve_device(device)``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import resolve_device
from tiatoolbox_tpu_torch.utils.store_conversion import dict_to_store_semantic_segmentor


class PromptSegmentor:
    """Interactive segmentation with point/box prompts (SAM).

    Args:
        model: SAM wrapper instance; constructed with the default
            checkpoint when None.
    """

    def __init__(self, model=None) -> None:
        if model is None:
            from tiatoolbox_tpu_torch.models.architecture.sam import SAM

            model = SAM()
        self.model = model
        self.scale = 1.0
        self.offset = np.array([0, 0])

    def run(
        self,
        images: list,
        point_coords: np.ndarray | None = None,
        box_coords: np.ndarray | None = None,
        save_dir: str | Path | None = None,
        device: str | None = None,
    ) -> list[Path]:
        """Segment each tile given prompts; save one store per tile.

        Args:
            images: List of HWC uint8 image tiles.
            point_coords: Per-image point prompts [N_im, N_points, 2].
            box_coords: Per-image box prompts [N_im, N_boxes, 4].
            save_dir: Directory for the per-tile ``{i}.db`` stores.
            device: Where SAM runs (``rcParam["device"]`` by default); a
                model without a ``to`` method runs where it is.

        Returns:
            Paths of the saved annotation stores.
        """
        if point_coords is None and box_coords is None:
            msg = "At least one of point_coords or box_coords must be given."
            raise ValueError(msg)
        dev = resolve_device(device)
        if hasattr(self.model, "to"):
            self.model.to(dev)
        masks = self.model.infer_batch(np.asarray(images), point_coords=point_coords, box_coords=box_coords)
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for i, mask in enumerate(masks):
            # SAM emits [n_prompts, n_masks, H, W]; union over prompt masks
            mask_arr = np.asarray(mask)
            while mask_arr.ndim > 2:
                mask_arr = np.any(mask_arr, axis=0)
            out_path = save_dir / f"{i}.db"
            dict_to_store_semantic_segmentor(
                {"predictions": mask_arr.astype(np.uint8)},
                scale_factor=(self.scale, self.scale),
                offset=tuple(self.offset),
                save_path=out_path,
            )
            paths.append(out_path)
        return paths

    def calc_mpp(self, area_dims, base_mpp: float, fixed_size: int = 1500) -> tuple[float, float]:
        """Scaled read mpp for a large interactive area (reference :88-115)."""
        scale = max(area_dims) / fixed_size if max(area_dims) > fixed_size else 1.0
        self.scale = scale
        return base_mpp * scale, scale
