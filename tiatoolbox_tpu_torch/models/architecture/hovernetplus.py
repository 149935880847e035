"""HoVer-Net+ (counterpart of ``tiatoolbox_tpu/models/architecture/hovernetplus.py:1-226``).

HoVer-Net in fast mode (``hovernet.py``) with a fourth decoder branch,
``ls``, for the tissue layers of oral epithelial dysplasia, under
upstream's names (``decoder.ls.u3.conva``, ...), so a reference ``.pth``
loads as it is. ``infer_batch_device`` returns np, hv and tp through
``HoVerNet._head_outputs`` and the argmax of the ls softmax as float32,
all NHWC on the device.

``postproc`` runs HoVer-Net's instance post-processing on ``[np, hv, tp]``
and, on the layer map, ``_proc_ls`` (:132-166) and ``_get_layer_info``
(:168-199) without cv2: the 20x20 closing and opening of ``cv2.morphologyEx``
in the port's host C++ (``native.morphology``, ``csrc/imgproc.cpp``) with
cv2's anchor (offsets -10..+9 on each axis) and neutral border, and the
layer contours from the port's tracer in ``cv2.findContours(RETR_TREE,
CHAIN_APPROX_NONE)``'s order (``native.find_contours_tree``); both equal
cv2's bit for bit.

Its four heads do not fit the packed fetch (``banded_fetch_spec`` takes
``[np, hv(, tp)]`` only), so the multitask engine takes the generic fetch,
as in JAX, and the layer task is a semantic task: in tile mode its map goes
through the engine's semantic canvases.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from tiatoolbox_tpu_torch import native, resolve_device
from tiatoolbox_tpu_torch.models.architecture.hovernet import (
    HoVerNet,
    _decoder_branch,
    _remove_small_objects,
    he_init,
    instance_columns,
)
from tiatoolbox_tpu_torch.utils.misc import get_bounding_box

LS_KERNEL_SIZE = 20
LS_MIN_EPITHELIUM = 20000


def morphology_close(mask: np.ndarray, ksize: int = LS_KERNEL_SIZE) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_CLOSE, np.ones((ksize, ksize)))`` of a 0/1 uint8 mask."""
    return native.morphology(mask, np.ones((ksize, ksize), np.uint8), "close")


def morphology_open(mask: np.ndarray, ksize: int = LS_KERNEL_SIZE) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_OPEN, np.ones((ksize, ksize)))`` of a 0/1 uint8 mask."""
    return native.morphology(mask, np.ones((ksize, ksize), np.uint8), "open")


class HoVerNetPlus(HoVerNet):
    """Simultaneous nuclear instance and tissue-layer segmentation.

    Args:
        num_input_channels: Input channels.
        num_types: Number of nucleus types.
        num_layers: Number of tissue layers.
        nuc_type_dict / layer_type_dict: id -> name mappings.
        compute_dtype / seed / device: As ``HoVerNet``.
    """

    def __init__(
        self,
        num_input_channels: int = 3,
        num_types: int | None = None,
        num_layers: int | None = None,
        nuc_type_dict: dict | None = None,
        layer_type_dict: dict | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(
            num_input_channels, num_types, mode="fast", nuc_type_dict=nuc_type_dict,
            compute_dtype=compute_dtype, seed=seed, device="cpu",
        )
        self.num_layers = num_layers
        self.layer_type_dict = layer_type_dict
        self.tasks = ["nuclei_segmentation", "layer_segmentation"]
        self.class_dict = {self.tasks[0]: nuc_type_dict, self.tasks[1]: layer_type_dict}
        self.decoder["ls"] = _decoder_branch(num_layers, 3)
        he_init(self.decoder["ls"], torch.Generator().manual_seed(seed + 1))
        self.place(device)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "HoVerNetPlus", batch_data, device=None):
        """uint8 NHWC batch -> (np, hv, tp, ls) float32 NHWC tensors on the
        device, unsynced; ls is the argmax of its softmax (``hovernetplus.py:103-128``)."""
        if device is not None:
            model.to(resolve_device(device))
        pred = model(model.stage_batch(batch_data).to(model.compute_dtype))
        ls = torch.softmax(pred["ls"].float(), dim=-1)
        return (*cls._head_outputs(pred), torch.argmax(ls, dim=-1, keepdim=True).float())

    @staticmethod
    def _proc_ls(ls_map: np.ndarray) -> np.ndarray:
        """The layer map cleaned: epithelium (layers 2-4) in components of at
        least 20,000 pixels, each layer closed then opened with a 20x20 box,
        over the closed and opened tissue mask (``hovernetplus.py:132``)."""
        ls_map = np.around(np.squeeze(np.asarray(ls_map))).astype("uint8")
        epith_all = (ls_map >= 2).astype("uint8")
        mask = (ls_map >= 1).astype("uint8")
        labelled = ndimage.label(epith_all > 0)[0]
        epith_mask = (_remove_small_objects(labelled, LS_MIN_EPITHELIUM) > 0).astype("uint8")
        epith_edited = (epith_mask * ls_map).astype("uint8")
        epith_edited_open = np.zeros_like(epith_edited)
        for i in (3, 2, 4):
            tmp = (epith_edited == i).astype("uint8")
            epith_edited_open[morphology_open(morphology_close(tmp)) == 1] = i
        ls_out = morphology_open(morphology_close(mask)).astype("uint8")
        for i in range(2, 5):
            ls_out[epith_edited_open == i] = i
        return ls_out

    @staticmethod
    def _get_layer_info(pred_layer: np.ndarray, offset=(0, 0)) -> dict:
        """``{n: box, contours, centroid, prob, type}`` of every contour of every
        layer, numbered in cv2's contour order (``hovernetplus.py:168``)."""
        layer_list = np.unique(pred_layer)
        layer_list = np.delete(layer_list, np.where(layer_list == 0))
        layer_info_dict = {}
        count = 1
        offset = np.asarray(offset)
        for type_class in layer_list:
            layer = (pred_layer == type_class).astype("uint8")
            bounding_box = get_bounding_box(layer)
            for contour in native.find_contours_tree(layer)[0]:
                # cv2's squeezed contour must be [k, 2] with k >= 3
                if len(contour) < 3:
                    continue
                coords = contour + offset
                box = bounding_box.copy()
                box[:2] += offset
                box[2:] += offset
                layer_info_dict[count] = {
                    "box": box,
                    "contours": coords,
                    "centroid": coords.mean(axis=0),
                    "prob": None,
                    "type": int(type_class),
                }
                count += 1
        return layer_info_dict

    def postproc(self, raw_maps: list, offset=(0, 0)) -> tuple:
        """[np, hv | energy, tp, ls] -> (nuclei instance result, layer result) (``hovernetplus.py:201``)."""
        np_map, hv_map, tp_map, ls_map = raw_maps
        nuclei_result = super().postproc([np_map, hv_map, tp_map], offset)[0]
        pred_layer = self._proc_ls(np.asarray(ls_map))
        layer_result = {
            "task_type": self.tasks[1],
            "predictions": pred_layer,
            "info_dict": instance_columns(self._get_layer_info(pred_layer, offset)),
            "seg_type": "semantic",
        }
        return (nuclei_result, layer_result)
