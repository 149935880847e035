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
(``csrc/watershed.cpp`` through ``tiatoolbox_tpu_torch.native``). It runs
on a per-thread scratch pool (``_Scratch``, :755-822): each step writes
into a named array of the map's shape (the helpers' ``out=``), which a
tile-mode worker keeps from one same-shaped tile to the next; the pool is
dropped after a call that needs more than 256 MiB. ``postproc`` takes
numpy maps or the engine's ``LazyRowsView``s (``postproc_accepts_views``)
and reads the energy only after the foreground is labelled.
``transform_canvas_for_postproc``, ``banded_fetch_spec``,
``block_fetch_transform`` and ``final_fetch_transform`` (:610-680) are the
engine's hooks: they run kernels K6 (pack, and the hv pair's min/max) and
K5 (energy, from that min/max) on the card.

Not ported (TPU-only): the block-diagonal dense-unit rewrite of
``optimize_for_inference`` (:127-158, :289-318; a bfloat16
``compute_dtype`` casts the weights when the model is built,
``ModelABC.place``).
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
        watershed (``hovernet.py:374``), with cv2's arithmetic, on this
        thread's scratch pool."""
        np_map, hv_map = np.asarray(np_map), np.asarray(hv_map)
        sc = _proc_scratch(np_map.shape[:2])
        blb = _foreground_labels(np_map[..., 0], out=sc["i32_a"])
        h_dir = normalize_minmax(hv_map[..., 0], out=sc["f32_a"])
        v_dir = normalize_minmax(hv_map[..., 1], out=sc["f32_b"])
        ksize = int((20 * scale_factor) + 1)
        # the normalised directions are dead once filtered: they take the normalised Sobels
        sobel_h = normalize_minmax(sobel(h_dir, 1, 0, ksize, out=sc["f64_a"]), out=sc["f32_a"])
        sobel_v = normalize_minmax(sobel(v_dir, 0, 1, ksize, out=sc["f64_b"]), out=sc["f32_b"])
        np.subtract(1, sobel_h, out=sobel_h)
        np.subtract(1, sobel_v, out=sobel_v)
        overall32 = np.maximum(sobel_h, sobel_v, out=sobel_h)
        return HoVerNet._proc_np_overall(blb, overall32, sc, scale_factor=scale_factor)

    @staticmethod
    def _proc_np_energy(np_map: np.ndarray, energy_map, scale_factor: float = 1) -> np.ndarray:
        """As ``_proc_np_hv`` from an energy map computed on the card (``hovernet.py:429``).

        The energy is read only after the foreground is labelled: where it
        arrives as a ``LazyRowsView`` of a buffer still filling, the
        labelling runs while the energy is on its way.
        """
        np_map = np.asarray(np_map)
        sc = _proc_scratch(np_map.shape[:2])
        blb = _foreground_labels(np_map[..., 0], out=sc["i32_a"])
        energy = np.asarray(energy_map)
        if energy.ndim == 3:
            energy = energy[..., 0]
        overall32 = sc.contiguous("f32_energy", energy.astype(np.float32, copy=False))
        return HoVerNet._proc_np_overall(blb, overall32, sc, scale_factor=scale_factor)

    @staticmethod
    def _proc_np_overall(blb: np.ndarray, overall32: np.ndarray, sc: _Scratch, scale_factor: float = 1) -> np.ndarray:
        """Energy + foreground -> instances (``hovernet.py:459-496``): markers
        where the energy is low, hole-filled, opened with the 5x5 ellipse,
        labelled, then flooded over the blurred distance map inside ``blb``.

        ``blb`` is ``sc["i32_a"]``; ``overall32`` may be ``sc["f32_a"]``, which
        is read before anything else is written. The pool is trimmed after.
        """
        obj_size = math.ceil(10 * (scale_factor**2))
        one_minus_blb = np.subtract(1, blb, out=sc["i32_b"])
        # float32 - int32 promotes to float64, as in the reference
        overall = np.subtract(overall32, one_minus_blb, out=sc["f64_a"])
        np.maximum(overall, 0, out=overall)
        dist = np.subtract(1.0, overall, out=sc["f64_b"])
        np.multiply(dist, blb, out=dist)
        dist = gaussian_blur_3x3(dist, out=sc["f64_c"])
        np.negative(dist, out=dist)
        marker = np.subtract(blb, np.greater_equal(overall, 0.4, out=sc["bool_a"]), out=sc["i32_b"])
        np.maximum(marker, 0, out=marker)
        marker_u8 = binary_open(fill_holes(marker, out=sc["u8_a"]), ellipse_kernel((5, 5)), out=sc["u8_b"])
        ndimage.label(marker_u8, output=marker)
        _remove_small_objects(marker, min_size=obj_size, out=marker)
        result = native.watershed(dist, marker, blb)
        # tile-sized working sets stay for the next call; a whole canvas's does not
        sc.trim()
        return result

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

    # postproc reads its maps in its own order (the foreground before the
    # energy), so the engine may hand it ``LazyRowsView``s still filling
    postproc_accepts_views = True

    def postproc(self, raw_maps: list, offset: tuple[int, int] = (0, 0)) -> tuple:
        """[np, hv | energy(, tp)] maps -> ({instance result},) (``hovernet.py:682``).

        A uint8 first map of two is the packed plane (fg in bit 0, the
        rounded type above it when the model has a type head); a
        one-channel second map is the energy computed on the card; two
        channels are hv maps for the host front-end. The maps are numpy
        arrays or ``LazyRowsView``s: the foreground is read first, the
        energy only after the foreground is labelled, and a separate type
        map after the instances.
        """
        tp_map = None
        if len(raw_maps) == 2 and raw_maps[0].dtype == np.uint8:
            packed = np.asarray(raw_maps[0])
            np_map = packed & 1
            if self.num_types is not None:
                tp_map = (packed[..., 0] >> 1).astype(np.uint8)
            hv_map = raw_maps[1]
        else:
            np_map, hv_map = np.asarray(raw_maps[0]), raw_maps[1]
        t0 = time.perf_counter()
        if hv_map.ndim == 3 and hv_map.shape[-1] == 1:
            pred_inst = HoVerNet._proc_np_energy(np_map, hv_map)
        else:
            pred_inst = HoVerNet._proc_np_hv(np_map, hv_map)
        t1 = time.perf_counter()
        if len(raw_maps) == 3:
            tp_map = np.asarray(raw_maps[2])
            if tp_map.dtype != np.uint8:
                tp_map = np.around(tp_map).astype("uint8")
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


_SCRATCH_DTYPES = {
    "f64": np.float64,
    "f32": np.float32,
    "i32": np.int32,
    "u8": np.uint8,
    "bool": np.bool_,
}
_SCRATCH_MAX_RETAIN_BYTES = 256 * 1024 * 1024
_ROW_BLOCK = 256  # rows the filters and the normalisation take at once


class _Scratch(threading.local):
    """Per-thread pool of named arrays of one map shape (JAX ``hovernet.py:764-819``).

    ``sc["f64_a"]`` is a float64 array of ``shape`` (a name's prefix is its
    dtype), made on first use and kept, so a post-processing thread that runs
    many same-shaped tiles reuses one working set instead of allocating
    (and having the kernel zero) tens of megabytes a call. Only the latest
    shape is kept, and ``trim`` drops the pool above
    ``_SCRATCH_MAX_RETAIN_BYTES``, so a whole-canvas call does not stay
    resident.
    """

    shape: tuple | None = None

    def _bufs(self) -> dict:
        bufs = getattr(self, "bufs", None)
        if bufs is None:
            bufs = self.bufs = {}
        return bufs

    def __getitem__(self, key: str) -> np.ndarray:
        bufs = self._bufs()
        buf = bufs.get(key)
        if buf is None:
            buf = bufs[key] = np.empty(self.shape, _SCRATCH_DTYPES[key.rsplit("_", 1)[0]])
        return buf

    def contiguous(self, key: str, arr: np.ndarray) -> np.ndarray:
        """``arr`` where it is C-contiguous, else its copy in the pool's ``key``."""
        if arr.flags.c_contiguous:
            return arr
        bufs = self._bufs()
        buf = bufs.get(key)
        if buf is None or buf.dtype != arr.dtype:
            buf = bufs[key] = np.empty(self.shape, arr.dtype)
        np.copyto(buf, arr)
        return buf

    def trim(self, max_bytes: int | None = None) -> None:
        """Drop the pool if it holds more than ``max_bytes`` (``_SCRATCH_MAX_RETAIN_BYTES``)."""
        bufs = getattr(self, "bufs", None)
        if not bufs:
            return
        cap = _SCRATCH_MAX_RETAIN_BYTES if max_bytes is None else max_bytes
        if sum(b.nbytes for b in bufs.values()) > cap:
            self.bufs = {}
            self.shape = None


_SCRATCH = _Scratch()


def _proc_scratch(shape: tuple) -> _Scratch:
    """This thread's pool, emptied first if it was for another shape."""
    shape = tuple(shape)
    if _SCRATCH.shape != shape:
        _SCRATCH.shape = shape
        _SCRATCH.bufs = {}
    return _SCRATCH


def _pooled(shape: tuple, key: str, out) -> np.ndarray | None:
    """The pool's ``key`` for a helper given an ``out`` buffer, else None (numpy allocates)."""
    return None if out is None else _proc_scratch(shape)[key]


def normalize_minmax(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """``cv2.normalize(x, None, 0, 1, NORM_MINMAX, CV_32F)`` bit for bit, into ``out``.

    OpenCV takes the min and max in float64, a scale ``1 / (max - min)``
    (0 when the range is at most DBL_EPSILON) rounded to float32, a shift
    ``-min * scale`` from that rounded scale, also rounded to float32, and
    then ``x * scale + shift`` in float64 with one rounding (a fused
    multiply-add) before rounding to float32. For float32 input the product
    is exact in float64, so a plain multiply and add is the same. The
    float64 work goes ``_ROW_BLOCK`` rows at a time.
    """
    x = np.asarray(x)
    smin, smax = float(x.min()), float(x.max())
    scale = 1.0 / (smax - smin) if smax - smin > np.finfo(np.float64).eps else 0.0
    a = float(np.float32(scale))
    b = float(np.float32(0.0 - smin * a))
    exact_product = np.finfo(x.dtype).nmant <= 23
    if out is None:
        out = np.empty(x.shape, np.float32)
    for y0 in range(0, x.shape[0], _ROW_BLOCK):
        rows = slice(y0, y0 + _ROW_BLOCK)
        x64 = x[rows].astype(np.float64)
        out[rows] = x64 * a + b if exact_product else _fused_multiply_add(x64, a, b)
    return out


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


def _separable_filter64(
    x: np.ndarray, k_row: np.ndarray, k_col: np.ndarray, out: np.ndarray | None = None
) -> np.ndarray:
    """OpenCV's float64 separable filter with BORDER_REFLECT_101, into ``out``.

    The row pass sums the taps in order (``RowFilter``); the column pass
    adds the rows paired around the centre before multiplying
    (``SymmColumnFilter``, symmetric or antisymmetric kernel), which is what
    makes the result equal cv2's bit for bit. Both passes go
    ``_ROW_BLOCK`` rows at a time (the reflected border gathered per
    block); the row pass's result is the pool's ``f64_rows`` when ``out``
    is given.
    """
    h, w = x.shape
    sym = np.array_equal(k_col, k_col[::-1])
    if not sym and not np.array_equal(k_col, -k_col[::-1]):
        msg = "The column kernel must be symmetric or antisymmetric."
        raise ValueError(msg)
    rows = _pooled((h, w), "f64_rows", out)
    if rows is None:
        rows = np.empty((h, w))
    if out is None:
        out = np.empty((h, w))
    r = len(k_row) // 2
    cols = reflect101_index(w, r)
    for y0 in range(0, h, _ROW_BLOCK):
        xp = x[y0 : y0 + _ROW_BLOCK].astype(np.float64)[:, cols]
        acc = rows[y0 : y0 + _ROW_BLOCK]
        np.multiply(xp[:, 0:w], k_row[0], out=acc)
        for j in range(1, len(k_row)):
            acc += k_row[j] * xp[:, j : j + w]
    r = len(k_col) // 2
    centre = k_col[r:]
    row_idx = reflect101_index(h, r)
    for y0 in range(0, h, _ROW_BLOCK):
        n = min(_ROW_BLOCK, h - y0)
        bp = rows[row_idx[y0 : y0 + n + 2 * r]]
        acc = out[y0 : y0 + n]
        if sym:
            np.multiply(bp[r : r + n], centre[0], out=acc)
            acc += 0.0
            for j in range(1, r + 1):
                acc += centre[j] * (bp[r + j : r + j + n] + bp[r - j : r - j + n])
        else:
            acc.fill(0.0)
            for j in range(1, r + 1):
                acc += centre[j] * (bp[r + j : r + j + n] - bp[r - j : r - j + n])
    return out


def sobel(x: np.ndarray, dx: int, dy: int, ksize: int, out: np.ndarray | None = None) -> np.ndarray:
    """``cv2.Sobel(x, CV_64F, dx, dy, ksize=ksize)`` for a first derivative, bit for bit."""
    deriv, smooth = (k.astype(np.float64) for k in sobel_kernels(ksize))
    k_row, k_col = (deriv, smooth) if dx else (smooth, deriv)
    return _separable_filter64(x, k_row, k_col, out)


def gaussian_blur_3x3(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """``cv2.GaussianBlur(x, (3, 3), 0)`` on float64, bit for bit (taps 1-2-1 / 4)."""
    taps = np.array([0.25, 0.5, 0.25])
    return _separable_filter64(x, taps, taps, out)


def binary_open(mask: np.ndarray, kernel: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_OPEN, kernel)`` on a 0/1 uint8 mask, into uint8 ``out``.

    OpenCV's border values leave the image edge alone: erosion treats
    outside pixels as set, dilation as unset. The kernel is symmetric
    with its anchor at the centre.
    """
    structure = kernel.astype(bool)
    fg = np.not_equal(mask, 0, out=_pooled(mask.shape, "bool_open", out))
    eroded = ndimage.binary_erosion(
        fg, structure=structure, border_value=1, output=_pooled(mask.shape, "bool_eroded", out)
    )
    if out is None:
        out = np.empty(mask.shape, np.uint8)
    ndimage.binary_dilation(eroded, structure=structure, output=out)
    return out


def fill_holes(marker: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """``ndimage.binary_fill_holes(marker != 0)`` as uint8 ``out``: a zero pixel is
    a hole unless 4-connected to the image border (``hovernet.py:825``)."""
    marker = np.asarray(marker)
    fg = np.not_equal(marker, 0, out=_pooled(marker.shape, "bool_fill", out))
    not_fg = np.logical_not(fg, out=_pooled(marker.shape, "bool_notfill", out))
    background = _pooled(marker.shape, "i32_fill", out)
    if background is None:
        background = np.empty(marker.shape, np.int32)
    n = ndimage.label(not_fg, output=background)
    if out is None:
        out = np.empty(marker.shape, np.uint8)
    if n == 0:
        np.copyto(out, fg)
        return out
    edge = np.concatenate([background[0], background[-1], background[:, 0], background[:, -1]])
    outside = np.zeros(n + 1, bool)
    outside[edge] = True
    outside[0] = True  # label 0 is the foreground itself
    # ``not_fg`` is dead: it takes ``~outside[background]``
    hole = np.take(outside, background, out=not_fg, mode="clip")
    np.logical_not(hole, out=hole)
    np.logical_or(fg, hole, out=hole)
    np.copyto(out, hole)
    return out


def _foreground_labels(blb_raw: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """``np >= 0.5``, labelled, objects under 10 pixels removed, then 0/1, into int32 ``out``."""
    blb_raw = np.asarray(blb_raw)
    fg = np.greater_equal(blb_raw, 0.5, out=_pooled(blb_raw.shape, "bool_fg", out))
    blb = np.empty(blb_raw.shape, np.int32) if out is None else out
    ndimage.label(fg, output=blb)
    _remove_small_objects(blb, min_size=10, out=blb)
    np.minimum(blb, 1, out=blb)
    return blb


def _remove_small_objects(labelled: np.ndarray, min_size: int, out: np.ndarray | None = None) -> np.ndarray:
    """Zero the labelled components smaller than ``min_size`` pixels (``hovernet.py:843``).

    Into ``out`` (which may be ``labelled`` itself); without one, a copy, or
    ``labelled`` itself where nothing is removed.
    """
    if min_size <= 1 or labelled.max() == 0:
        if out is None or out is labelled:
            return labelled
        np.copyto(out, labelled)
        return out
    counts = np.bincount(labelled.ravel())
    too_small = counts < min_size
    too_small[0] = False
    drop = np.take(too_small, labelled, out=_pooled(labelled.shape, "bool_small", out), mode="clip")
    if out is None:
        out = labelled.copy()
    elif out is not labelled:
        np.copyto(out, labelled)
    out[drop] = 0
    return out
