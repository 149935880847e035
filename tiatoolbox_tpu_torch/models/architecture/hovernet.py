"""HoVer-Net (counterpart of ``tiatoolbox_tpu/models/architecture/hovernet.py:1-896``).

The network (:35-245): a pre-activation ResNet-50 encoder (1x1 valid and
3x3 SAME convolutions) and one decoder per branch (np, hv and, with
``num_types``, tp) built from valid-padding dense blocks with grouped
convolutions, in two modes: "fast" (256 in, 164 out, SAME stem) and
"original" (270 in, 80 out, valid stem). Modules carry upstream
tiatoolbox's names (``conv0./``, ``d0.units.0.conv1/bn``,
``decoder.np.u3.dense.units.0.preact_bna/bn``, ...), so a reference
``.pth`` ``state_dict`` loads as it is. ``TFSamepaddingLayer`` pads as
flax's SAME does: on an even input a stride-2 3x3 convolution gets 0 rows
and columns at the top and left and 1 at the bottom and right, which
``nn.Conv2d(padding=1)`` would not reproduce.

``HoVerNet.infer_batch_device`` (:355) runs the forward and the head math
of :320-333 on the device: softmax over np (the foreground channel is
kept), hv passed through, argmax of the tp softmax as float32.

The host post-processing (:374-760) is here without cv2: min-max
normalisation, the ksize-21 Sobel and the 3x3 Gaussian blur in numpy with
OpenCV's order of operations (row taps in order, column taps paired
around the centre), so each equals cv2's result bit for bit; the 5x5
elliptical opening and the hole filling with ``scipy.ndimage``; the marker
watershed and the contour follower in the port's own host C++
(``csrc/watershed.cpp`` through ``tiatoolbox_tpu_torch.native``).
``transform_canvas_for_postproc``, ``banded_fetch_spec``,
``block_fetch_transform`` and ``final_fetch_transform`` (:610-680) are the
engine's hooks: they run kernels K6 (pack, and the hv pair's min/max) and
K5 (energy, from that min/max) on the card.

Not ported (TPU-only): the block-diagonal dense-unit rewrite of
``optimize_for_inference`` (:127-158, :289-318; a bfloat16
``compute_dtype`` casts the weights when the model is built,
``ModelABC.place``) and the per-thread scratch pool ``_Scratch``
(:764-822).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from torch import nn

from tiatoolbox_tpu_torch import native, resolve_device
from tiatoolbox_tpu_torch.models.architecture.utils import (
    centre_crop,
    centre_crop_to_shape,
    upsample2x,
)
from tiatoolbox_tpu_torch.models.models_abc import ModelABC
from tiatoolbox_tpu_torch.ops.canvas import pack_fg_tp
from tiatoolbox_tpu_torch.ops.hv_energy import hv_energy, reflect101_index, sobel_kernels
from tiatoolbox_tpu_torch.tools.tissuemask import ellipse_kernel

_POSTPROC_TIMING_LOCK = threading.Lock()


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5)


class TFSamepaddingLayer(nn.Module):
    """Zero padding of flax's (TensorFlow's) SAME convolution for ``ksize``
    and ``stride``: the odd pixel of an uneven total goes to the bottom and right."""

    def __init__(self, ksize: int, stride: int) -> None:
        super().__init__()
        self.ksize = ksize
        self.stride = stride

    def _pads(self, size: int) -> tuple[int, int]:
        out = -(-size // self.stride)
        total = max((out - 1) * self.stride + self.ksize - size, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW input, padded on its last two axes."""
        top, bottom = self._pads(x.shape[2])
        left, right = self._pads(x.shape[3])
        return F.pad(x, (left, right, top, bottom))


class ResidualBlock(nn.Module):
    """Pre-activation residual stage (``hovernet.py:64``): per unit 1x1 valid,
    3x3 SAME (stride on the first unit), 1x1 valid; a final BN and ReLU."""

    def __init__(
        self, in_ch: int, unit_ksize, unit_ch, unit_count: int, stride: int = 1
    ) -> None:
        super().__init__()
        self.units = nn.ModuleList()
        unit_in_ch = in_ch
        for idx in range(unit_count):
            unit_stride = stride if idx == 0 else 1
            layers = [
                ("preact/bn", _bn(unit_in_ch)),
                ("preact/relu", nn.ReLU()),
                ("conv1", nn.Conv2d(unit_in_ch, unit_ch[0], unit_ksize[0], bias=False)),
                ("conv1/bn", _bn(unit_ch[0])),
                ("conv1/relu", nn.ReLU()),
                ("conv2/pad", TFSamepaddingLayer(unit_ksize[1], unit_stride)),
                (
                    "conv2",
                    nn.Conv2d(unit_ch[0], unit_ch[1], unit_ksize[1], stride=unit_stride, bias=False),
                ),
                ("conv2/bn", _bn(unit_ch[1])),
                ("conv2/relu", nn.ReLU()),
                ("conv3", nn.Conv2d(unit_ch[1], unit_ch[2], unit_ksize[2], bias=False)),
            ]
            # the previous stage ends in BN-ReLU: no pre-activation on unit 0
            self.units.append(nn.Sequential(OrderedDict(layers if idx else layers[2:])))
            unit_in_ch = unit_ch[-1]
        self.shortcut = None
        if in_ch != unit_ch[-1] or stride != 1:
            self.shortcut = nn.Conv2d(in_ch, unit_ch[-1], 1, stride=stride, bias=False)
        self.blk_bna = nn.Sequential(OrderedDict([("bn", _bn(unit_in_ch)), ("relu", nn.ReLU())]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        prev = x
        for unit in self.units:
            prev = unit(prev) + shortcut
            shortcut = prev
        return self.blk_bna(prev)


class DenseBlock(nn.Module):
    """Valid-padding dense block (``hovernet.py:99``): each unit shrinks the
    map by ``ksize - 1`` and its ``split``-group convolution adds
    ``unit_ch[1]`` channels to the centre-cropped input."""

    def __init__(self, in_ch: int, unit_ksize, unit_ch, unit_count: int, split: int = 1) -> None:
        super().__init__()
        self.units = nn.ModuleList()
        unit_in_ch = in_ch
        for _ in range(unit_count):
            layers = [
                ("preact_bna/bn", _bn(unit_in_ch)),
                ("preact_bna/relu", nn.ReLU()),
                ("conv1", nn.Conv2d(unit_in_ch, unit_ch[0], unit_ksize[0], bias=False)),
                ("conv1/bn", _bn(unit_ch[0])),
                ("conv1/relu", nn.ReLU()),
                (
                    "conv2",
                    nn.Conv2d(unit_ch[0], unit_ch[1], unit_ksize[1], groups=split, bias=False),
                ),
            ]
            self.units.append(nn.Sequential(OrderedDict(layers)))
            unit_in_ch += unit_ch[1]
        self.blk_bna = nn.Sequential(OrderedDict([("bn", _bn(unit_in_ch)), ("relu", nn.ReLU())]))

    def forward(self, prev: torch.Tensor) -> torch.Tensor:
        for unit in self.units:
            new = unit(prev)
            prev = torch.cat([centre_crop_to_shape(prev, new, "NCHW"), new], dim=1)
        return self.blk_bna(prev)


def _decoder_branch(out_ch: int, ksize: int) -> nn.Sequential:
    """One decoder head, u3 -> u2 -> u1 -> u0 (``hovernet.py:161``)."""
    u3 = nn.Sequential(
        OrderedDict(
            [
                ("conva", nn.Conv2d(1024, 256, ksize, bias=False)),
                ("dense", DenseBlock(256, (1, ksize), (128, 32), 8, split=4)),
                ("convf", nn.Conv2d(512, 512, 1, bias=False)),
            ]
        )
    )
    u2 = nn.Sequential(
        OrderedDict(
            [
                ("conva", nn.Conv2d(512, 128, ksize, bias=False)),
                ("dense", DenseBlock(128, (1, ksize), (128, 32), 4, split=4)),
                ("convf", nn.Conv2d(256, 256, 1, bias=False)),
            ]
        )
    )
    u1 = nn.Sequential(
        OrderedDict(
            [
                ("conva/pad", TFSamepaddingLayer(ksize, 1)),
                ("conva", nn.Conv2d(256, 64, ksize, bias=False)),
            ]
        )
    )
    u0 = nn.Sequential(
        OrderedDict(
            [("bn", _bn(64)), ("relu", nn.ReLU()), ("conv", nn.Conv2d(64, out_ch, 1, bias=True))]
        )
    )
    return nn.Sequential(OrderedDict([("u3", u3), ("u2", u2), ("u1", u1), ("u0", u0)]))


def he_init(module: nn.Module, gen: torch.Generator) -> None:
    """He-normal (fan out) convolution weights drawn from ``gen``, zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def instance_columns(info_dict: dict) -> dict:
    """``{key: object array over instances}`` of an instance-info dict, empty
    arrays when there is none (the ``info_dict`` of ``postproc``'s results)."""
    keys = ("box", "centroid", "contours", "prob", "type")
    if not info_dict:
        return {k: np.empty(0) for k in keys}
    return {k: np.array([info_dict[i][k] for i in info_dict], dtype=object) for k in keys}


class HoVerNet(ModelABC):
    """Nucleus instance segmentation (and, with ``num_types``, typing).

    Args:
        num_input_channels: Input channels (3 for RGB).
        num_types: Number of nucleus types (enables the tp branch).
        mode: "original" (270 -> 80) or "fast" (256 -> 164).
        nuc_type_dict: Optional id -> name mapping of the types.
        compute_dtype: dtype of the forward pass.
        seed: Seed of the ``torch.Generator`` the random weights come from.
        device: Where the model lives; ``rcParam["device"]`` by default.
    """

    def __init__(
        self,
        num_input_channels: int = 3,
        num_types: int | None = None,
        mode: str = "original",
        nuc_type_dict: dict | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        if mode not in ("original", "fast"):
            msg = f"Invalid mode {mode} for HoVerNet. Only support `original` or `fast`."
            raise ValueError(msg)
        super().__init__(compute_dtype)
        self.mode = mode
        self.num_types = num_types
        self.nuc_type_dict = nuc_type_dict
        self.tasks = ["nuclei_segmentation"]
        self.class_dict = {self.tasks[0]: nuc_type_dict}
        stem = [
            ("/", nn.Conv2d(num_input_channels, 64, 7, bias=False)),
            ("bn", _bn(64)),
            ("relu", nn.ReLU()),
        ]
        if mode == "fast":
            stem.insert(0, ("pad", TFSamepaddingLayer(7, 1)))
        self.conv0 = nn.Sequential(OrderedDict(stem))
        self.d0 = ResidualBlock(64, (1, 3, 1), (64, 64, 256), 3, stride=1)
        self.d1 = ResidualBlock(256, (1, 3, 1), (128, 128, 512), 4, stride=2)
        self.d2 = ResidualBlock(512, (1, 3, 1), (256, 256, 1024), 6, stride=2)
        self.d3 = ResidualBlock(1024, (1, 3, 1), (512, 512, 2048), 3, stride=2)
        self.conv_bot = nn.Conv2d(2048, 1024, 1, bias=False)
        ksize = 5 if mode == "original" else 3
        branches = [("np", 2), ("hv", 2)]
        if num_types is not None:
            branches.insert(0, ("tp", num_types))
        self.decoder = nn.ModuleDict(
            OrderedDict((name, _decoder_branch(ch, ksize)) for name, ch in branches)
        )
        he_init(self, torch.Generator().manual_seed(seed))
        self.place(device)

    def forward(self, batch: torch.Tensor) -> dict[str, torch.Tensor]:
        """NHWC float batch in [0, 255] -> {branch: NHWC logits}; the /255 is
        inside the network (``hovernet.py:213``)."""
        x = batch.permute(0, 3, 1, 2) / 255.0
        d0 = self.d0(self.conv0(x))
        d1 = self.d1(d0)
        d2 = self.d2(d1)
        d3 = self.conv_bot(self.d3(d2))
        crops = ((184, 184), (72, 72)) if self.mode == "original" else ((92, 92), (36, 36))
        d = [centre_crop(d0, crops[0], "NCHW"), centre_crop(d1, crops[1], "NCHW"), d2, d3]
        out = {}
        for name, branch in self.decoder.items():
            u3 = branch.u3(upsample2x(d[-1], "NCHW") + d[-2])
            u2 = branch.u2(upsample2x(u3, "NCHW") + d[-3])
            u1 = branch.u1(upsample2x(u2, "NCHW") + d[-4])
            out[name] = branch.u0(u1).permute(0, 2, 3, 1)
        return out

    # -- inference ----------------------------------------------------------------

    @staticmethod
    def _head_outputs(pred: dict) -> tuple[torch.Tensor, ...]:
        """Softmax np -> foreground probability, hv as float32, argmax of the
        tp softmax as float32 (``hovernet.py:320-333``)."""
        np_map = torch.softmax(pred["np"].float(), dim=-1)[..., 1:]
        hv_map = pred["hv"].float()
        heads = [np_map.contiguous(), hv_map.contiguous()]
        if "tp" in pred:
            tp = torch.softmax(pred["tp"].float(), dim=-1)
            heads.append(torch.argmax(tp, dim=-1, keepdim=True).float())
        return tuple(heads)

    @classmethod
    @torch.inference_mode()
    def infer_batch_device(cls, model: "HoVerNet", batch_data, device=None):
        """uint8 NHWC batch -> (np, hv[, tp]) float32 NHWC tensors on the device, unsynced."""
        if device is not None:
            model.to(resolve_device(device))
        x = model.stage_batch(batch_data)
        return cls._head_outputs(model(x.to(model.compute_dtype)))

    @classmethod
    def infer_batch(cls, model: "HoVerNet", batch_data, device=None) -> tuple[np.ndarray, ...]:
        """As ``infer_batch_device``, fetched to numpy (``hovernet.py:346``)."""
        return tuple(h.cpu().numpy() for h in cls.infer_batch_device(model, batch_data, device))

    # -- post-processing ----------------------------------------------------------

    @staticmethod
    def _proc_np_hv(np_map: np.ndarray, hv_map: np.ndarray, scale_factor: float = 1) -> np.ndarray:
        """NP + HV maps -> labelled instances through the Sobel-energy
        watershed (``hovernet.py:374``), with cv2's arithmetic."""
        blb = _foreground_labels(np.asarray(np_map)[..., 0])
        hv_map = np.asarray(hv_map)
        h_dir = normalize_minmax(hv_map[..., 0])
        v_dir = normalize_minmax(hv_map[..., 1])
        ksize = int((20 * scale_factor) + 1)
        sobel_h = np.subtract(1, normalize_minmax(sobel(h_dir, 1, 0, ksize)))
        sobel_v = np.subtract(1, normalize_minmax(sobel(v_dir, 0, 1, ksize)))
        overall32 = np.maximum(sobel_h, sobel_v)
        return HoVerNet._proc_np_overall(blb, overall32, scale_factor=scale_factor)

    @staticmethod
    def _proc_np_energy(np_map: np.ndarray, energy_map: np.ndarray, scale_factor: float = 1) -> np.ndarray:
        """As ``_proc_np_hv`` from an energy map computed on the card (``hovernet.py:429``)."""
        blb = _foreground_labels(np.asarray(np_map)[..., 0])
        energy = np.asarray(energy_map)
        if energy.ndim == 3:
            energy = energy[..., 0]
        overall32 = np.ascontiguousarray(energy, dtype=np.float32)
        return HoVerNet._proc_np_overall(blb, overall32, scale_factor=scale_factor)

    @staticmethod
    def _proc_np_overall(blb: np.ndarray, overall32: np.ndarray, scale_factor: float = 1) -> np.ndarray:
        """Energy + foreground -> instances (``hovernet.py:459-496``): markers
        where the energy is low, hole-filled, opened with the 5x5 ellipse,
        labelled, then flooded over the blurred distance map inside ``blb``."""
        obj_size = math.ceil(10 * (scale_factor**2))
        # float32 - int32 promotes to float64, as in the reference
        overall = np.maximum(overall32 - (1 - blb), 0)
        dist = gaussian_blur_3x3((1.0 - overall) * blb)
        dist = np.negative(dist)
        marker = np.maximum(blb - (overall >= 0.4), 0)
        marker_u8 = binary_open(fill_holes(marker), ellipse_kernel((5, 5)))
        marker = ndimage.label(marker_u8)[0].astype(np.int32)
        marker = _remove_small_objects(marker, min_size=obj_size)
        return native.watershed(dist, marker, blb)

    @staticmethod
    def get_instance_info(
        pred_inst: np.ndarray,
        pred_type: np.ndarray | None = None,
        offset: tuple[int, int] = (0, 0),
        *,
        verbose: bool = True,  # noqa: ARG004
    ) -> dict:
        """Per-instance box, centroid, contour, type and type probability (``hovernet.py:499``).

        Boxes come from ``ndimage.find_objects``, centroids and per-type
        pixel counts from one global pass, and every contour from one call
        of the host contour follower, which traces each instance from its
        first pixel in raster order as ``cv2.findContours(RETR_TREE,
        CHAIN_APPROX_SIMPLE)[0][0]`` does on the instance's crop. An
        instance whose contour has fewer than 3 points is dropped.
        """
        pred_inst = np.ascontiguousarray(pred_inst, dtype=np.int32)
        offset = np.asarray(offset)
        max_label = int(pred_inst.max()) if pred_inst.size else 0
        if max_label == 0:
            return {}
        slices = ndimage.find_objects(pred_inst, max_label=max_label)
        rows_fg, cols_fg = np.nonzero(pred_inst)
        labels_fg = pred_inst[rows_fg, cols_fg].astype(np.int64)
        areas = np.bincount(labels_fg, minlength=max_label + 1)
        sum_x = np.bincount(labels_fg, weights=cols_fg, minlength=max_label + 1)
        sum_y = np.bincount(labels_fg, weights=rows_fg, minlength=max_label + 1)
        type_counts = None
        if pred_type is not None:
            pt = np.asarray(pred_type)
            if pt.ndim == 3:
                pt = pt[..., 0]
            tvals = pt[rows_fg, cols_fg].astype(np.int64)
            n_types = int(tvals.max()) + 1 if len(tvals) else 1
            type_counts = np.bincount(
                labels_fg * n_types + tvals, minlength=(max_label + 1) * n_types
            ).reshape(max_label + 1, n_types)
        # first pixel of each label in raster order: its contour's start
        ids, first = np.unique(labels_fg, return_index=True)
        starts = np.stack([rows_fg[first], cols_fg[first]], axis=-1)
        contours = native.outer_contours(pred_inst, ids, starts, areas[ids])
        out = {}
        for inst_id, contour in zip(ids.tolist(), contours):
            slc = slices[inst_id - 1]
            rows, cols = slc
            inst_box = np.array([cols.start, rows.start, cols.stop, rows.stop])
            inst_box_tl = inst_box[:2] + offset
            area = areas[inst_id]
            if contour.shape[0] < 3:
                continue
            inst_centroid = np.array(
                [sum_x[inst_id] / area - inst_box[0], sum_y[inst_id] / area - inst_box[1]]
            )
            info = {
                "box": inst_box + np.concatenate([offset, offset]),
                "centroid": inst_centroid + inst_box_tl,
                "contours": (contour - inst_box[None, :2]) + inst_box_tl[None],
                "prob": None,
                "type": None,
            }
            if type_counts is not None:
                counts = type_counts[inst_id]
                # sorted by count, descending, stable over ascending type:
                # the largest count, the smallest type on ties; background
                # only where no other type is present
                inst_type = int(np.argmax(counts))
                if inst_type == 0 and (counts > 0).sum() > 1:
                    rest = counts.copy()
                    rest[0] = -1
                    inst_type = int(np.argmax(rest))
                info["type"] = inst_type
                info["prob"] = float(counts[inst_type] / (area + 1.0e-6))
            out[int(inst_id)] = info
        return out

    # -- engine hooks (run on the card) --------------------------------------------
    #
    # The watershed reads the stitched canvas through three inputs: the
    # foreground (np >= 0.5) and the rounded type map are pointwise and pack
    # into one uint8 plane (K6); the energy needs the whole canvas's min and
    # max and leaves in a plane of its own (K5). K6 reads whole pixels, so it
    # also reduces the hv pair's min and max, which K5 then takes instead of
    # reading the canvas once more for them.

    def transform_canvas_for_postproc(self, normalized_canvas: torch.Tensor, head_channels):
        """``[np, hv0, hv1(, rest)]`` -> ``([np, energy(, rest)], channels)`` on the
        device (``hovernet.py:610``); None for another layout."""
        if list(head_channels[:2]) != [1, 2]:
            return None
        energy = hv_energy(normalized_canvas[..., 1:3])[..., None]
        out = torch.cat([normalized_canvas[..., :1], energy, normalized_canvas[..., 3:]], dim=-1)
        return out, [1, 1, *head_channels[2:]]

    def banded_fetch_spec(self, head_channels) -> bool:
        """Whether these heads leave the card as the packed uint8 plane and the
        energy, one plane each (``hovernet.py:652``): ``[np, hv]`` with or
        without the type head.

        The engine then calls ``block_fetch_transform``, which returns
        ``(plane, state)``, and passes ``state`` unread to
        ``final_fetch_transform``. HoVerNet's state is the normalised hv
        pair's ``(min h, max h, min v, max v)``, which K6 reduces while it
        packs the plane and K5 takes in place of its own min/max pass."""
        return list(head_channels) in ([1, 2, 1], [1, 2])

    def block_fetch_transform(self, canvas, count, height: int, width: int, head_channels):
        """``fg | round(tp) << 1`` as a uint8 ``[height, width, 1]`` plane of the
        count-normalised canvas (K6; ``hovernet.py:662`` with
        ``semantic_segmentor.py:461-495``), and the fetch state: the
        normalised hv pair's ``(min h, max h, min v, max v)`` from the same
        pass, a float32 ``[4]`` tensor for ``final_fetch_transform``."""
        tp_channel = 3 if len(head_channels) == 3 else -1
        return pack_fg_tp(canvas, count, height, width, tp_channel=tp_channel)

    def final_fetch_transform(
        self, canvas, count, height: int, width: int, head_channels, state, dtype=torch.float32  # noqa: ARG002
    ):
        """The watershed energy ``[height, width, 1]`` of the count-normalised
        canvas (K5, ``hovernet.py:674``), read from the raw canvas: the kernel
        divides the hv pair by the count as it loads it, so no normalised copy
        of the canvas is made. ``state`` is ``block_fetch_transform``'s
        min/max of the pair, so K5 skips its own min/max pass."""
        crop = (slice(0, height), slice(0, width))
        return hv_energy(canvas[crop][..., 1:3], count=count[crop], dtype=dtype, minmax=state)[..., None]

    def postproc(self, raw_maps: list, offset: tuple[int, int] = (0, 0)) -> tuple:
        """[np, hv | energy(, tp)] maps -> ({instance result},) (``hovernet.py:682``).

        A uint8 first map of two is the packed plane (fg in bit 0, the
        rounded type above it when the model has a type head); a
        one-channel second map is the energy computed on the card; two
        channels are hv maps for the host front-end.
        """
        if len(raw_maps) == 2 and np.asarray(raw_maps[0]).dtype == np.uint8:
            packed = np.asarray(raw_maps[0])
            np_map = packed & 1
            tp_map = (packed[..., 0] >> 1).astype(np.uint8) if self.num_types is not None else None
            hv_map = np.asarray(raw_maps[1])
        elif len(raw_maps) == 3:
            np_map, hv_map, tp_map = (np.asarray(m) for m in raw_maps)
            if tp_map.dtype != np.uint8:
                tp_map = np.around(tp_map).astype("uint8")
        else:
            tp_map = None
            np_map, hv_map = (np.asarray(m) for m in raw_maps)
        t0 = time.perf_counter()
        if hv_map.ndim == 3 and hv_map.shape[-1] == 1:
            pred_inst = HoVerNet._proc_np_energy(np_map, hv_map)
        else:
            pred_inst = HoVerNet._proc_np_hv(np_map, hv_map)
        t1 = time.perf_counter()
        info_dict = HoVerNet.get_instance_info(pred_inst, tp_map, offset)
        t2 = time.perf_counter()
        # accumulated across the tile-mode calls of a run (worker threads)
        with _POSTPROC_TIMING_LOCK:
            acc = getattr(self, "last_postproc_seconds", None) or {
                "watershed": 0.0,
                "instance_info": 0.0,
            }
            acc["watershed"] += t1 - t0
            acc["instance_info"] += t2 - t1
            self.last_postproc_seconds = acc
        return (
            {
                "task_type": self.tasks[0],
                "predictions": pred_inst,
                "info_dict": instance_columns(info_dict),
                "seg_type": "instance",
            },
        )


# -- host pieces of the watershed, without cv2 ----------------------------------------


def normalize_minmax(x: np.ndarray) -> np.ndarray:
    """``cv2.normalize(x, None, 0, 1, NORM_MINMAX, CV_32F)`` bit for bit.

    OpenCV takes the min and max in float64, a scale ``1 / (max - min)``
    (0 when the range is at most DBL_EPSILON) rounded to float32, a shift
    ``-min * scale`` from that rounded scale, also rounded to float32, and
    then ``x * scale + shift`` in float64 with one rounding (a fused
    multiply-add) before rounding to float32. For float32 input the product
    is exact in float64, so a plain multiply and add is the same.
    """
    x = np.asarray(x)
    smin, smax = float(x.min()), float(x.max())
    scale = 1.0 / (smax - smin) if smax - smin > np.finfo(np.float64).eps else 0.0
    a = float(np.float32(scale))
    b = float(np.float32(0.0 - smin * a))
    x64 = x.astype(np.float64)
    if np.finfo(x.dtype).nmant <= 23:
        return (x64 * a + b).astype(np.float32)
    return _fused_multiply_add(x64, a, b).astype(np.float32)


def _two_sum(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``s + e == a + b`` exactly, ``s`` the rounded sum (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fused_multiply_add(x: np.ndarray, a: float, b: float) -> np.ndarray:
    """``x * a + b`` rounded once to float64, for ``a`` with a float32 mantissa.

    ``x`` splits exactly into three parts of at most 24 significant bits,
    so each partial product is exact in float64; the sum of the products
    and ``b`` is then taken with its rounding errors carried along.
    """
    hi = x.astype(np.float32).astype(np.float64)
    rest = x - hi
    mid = rest.astype(np.float32).astype(np.float64)
    lo = rest - mid
    s, err = _two_sum(hi * a, b)
    return s + (err + (mid * a + lo * a))


def _separable_filter64(x: np.ndarray, k_row: np.ndarray, k_col: np.ndarray) -> np.ndarray:
    """OpenCV's float64 separable filter with BORDER_REFLECT_101.

    The row pass sums the taps in order (``RowFilter``); the column pass
    adds the rows paired around the centre before multiplying
    (``SymmColumnFilter``, symmetric or antisymmetric kernel), which is what
    makes the result equal cv2's bit for bit.
    """
    h, w = x.shape
    r = len(k_row) // 2
    xp = x.astype(np.float64)[:, reflect101_index(w, r)]
    rows = k_row[0] * xp[:, 0:w]
    for j in range(1, len(k_row)):
        rows = rows + k_row[j] * xp[:, j : j + w]
    r = len(k_col) // 2
    bp = rows[reflect101_index(h, r)]
    centre = k_col[r:]
    if np.array_equal(k_col, k_col[::-1]):
        out = centre[0] * bp[r : r + h] + 0.0
        for j in range(1, r + 1):
            out = out + centre[j] * (bp[r + j : r + j + h] + bp[r - j : r - j + h])
    elif np.array_equal(k_col, -k_col[::-1]):
        out = np.zeros((h, w))
        for j in range(1, r + 1):
            out = out + centre[j] * (bp[r + j : r + j + h] - bp[r - j : r - j + h])
    else:
        msg = "The column kernel must be symmetric or antisymmetric."
        raise ValueError(msg)
    return out


def sobel(x: np.ndarray, dx: int, dy: int, ksize: int) -> np.ndarray:
    """``cv2.Sobel(x, CV_64F, dx, dy, ksize=ksize)`` for a first derivative, bit for bit."""
    deriv, smooth = (k.astype(np.float64) for k in sobel_kernels(ksize))
    k_row, k_col = (deriv, smooth) if dx else (smooth, deriv)
    return _separable_filter64(x, k_row, k_col)


def gaussian_blur_3x3(x: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(x, (3, 3), 0)`` on float64, bit for bit (taps 1-2-1 / 4)."""
    taps = np.array([0.25, 0.5, 0.25])
    return _separable_filter64(x, taps, taps)


def binary_open(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_OPEN, kernel)`` on a 0/1 uint8 mask.

    OpenCV's border values leave the image edge alone: erosion treats
    outside pixels as set, dilation as unset. The kernel is symmetric
    with its anchor at the centre.
    """
    structure = kernel.astype(bool)
    eroded = ndimage.binary_erosion(mask != 0, structure=structure, border_value=1)
    return ndimage.binary_dilation(eroded, structure=structure).astype(np.uint8)


def fill_holes(marker: np.ndarray) -> np.ndarray:
    """``ndimage.binary_fill_holes(marker != 0)`` as uint8: a zero pixel is a
    hole unless 4-connected to the image border (``hovernet.py:825``)."""
    fg = np.asarray(marker) != 0
    background, n = ndimage.label(~fg)
    if n == 0:
        return fg.astype(np.uint8)
    edge = np.concatenate([background[0], background[-1], background[:, 0], background[:, -1]])
    outside = np.zeros(n + 1, bool)
    outside[edge] = True
    outside[0] = True  # label 0 is the foreground itself
    return (fg | ~outside[background]).astype(np.uint8)


def _foreground_labels(blb_raw: np.ndarray) -> np.ndarray:
    """``np >= 0.5``, labelled, objects under 10 pixels removed, then 0/1 int32."""
    blb = ndimage.label(blb_raw >= 0.5)[0].astype(np.int32)
    blb = _remove_small_objects(blb, min_size=10)
    return np.minimum(blb, 1)


def _remove_small_objects(labelled: np.ndarray, min_size: int) -> np.ndarray:
    """Zero the labelled components smaller than ``min_size`` pixels (``hovernet.py:843``)."""
    if min_size <= 1 or labelled.max() == 0:
        return labelled
    counts = np.bincount(labelled.ravel())
    too_small = counts < min_size
    too_small[0] = False
    out = labelled.copy()
    out[too_small[labelled]] = 0
    return out
