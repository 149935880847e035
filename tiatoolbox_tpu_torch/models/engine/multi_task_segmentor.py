"""Multi-head (instance) segmentation engine (counterpart of
``tiatoolbox_tpu/models/engine/multi_task_segmentor.py:1-886``).

The HoVer-Net heads ``[np, hv, tp]`` share one output patch, so every batch
is concatenated into 4 channels and scatter-added (K2) into one device
canvas with a hit count (``_infer_wsi_device_canvas_multihead``, :236).
After the loop the canvas leaves the card in the form the post-processing
needs:

- **banded** (region feed, canvas at most ``full_postproc_limit``, :268-374):
  the model's ``block_fetch_transform`` packs ``fg | round(tp) << 1`` into a
  uint8 plane and returns it with a fetch state of its own (HoVerNet's: the
  normalised hv pair's min and max, reduced in the same pass, K6), and
  ``final_fetch_transform`` takes that state and computes the watershed
  energy (K5) from the raw canvas and count, dividing on load, so this path
  makes no normalised copy of the canvas (no K3) and K5 no min/max pass; the
  engine passes the state on and never reads it. The plane is JAX's one
  whole-canvas ``BlockDrain`` block, its copy queued first, and the energy
  follows through ``fetch_chunked_async``.
- **transformed** (per-patch feed, :376-427): the normalised canvas goes
  through ``transform_canvas_for_postproc`` (``[np, energy, tp]``, K5) and
  leaves through ``fetch_chunked_async``.
- **raw**: a canvas over ``full_postproc_limit`` (tile mode) or a caller
  that wants the maps leaves as the normalised ``[np, hv, tp]`` (K3).
- **host canvas** (:105-206): a canvas over the device budget is added up
  from each batch's fetched heads, in RAM or, with a ``save_dir`` and
  canvases over ``memory_threshold`` of free RAM, in zarr arrays under
  ``save_dir/cache`` (``create_smart_array``); tile mode then reads them tile
  by tile, and semantic task maps go the same way (:740-752).

The region feed is the semantic engine's, ``band_wire="yuv420"`` (packed
bands unpacked on the card by K8) included, and the stage summary names the
band wire on either feed (:368, :422).

``post_process_wsi`` (:449) runs the model's ``postproc`` on the whole map,
or, above ``full_postproc_limit``, the reference's 4-pass tile scheme
(:505-787) on a thread pool: grid tiles, vertical and horizontal boundary
strips and cross-section tiles, each with removal flags, so every instance
is owned by exactly one pass. Instances are keyed by ``uuid4``.

``save_predictions`` (:811-875) writes the instances as an AnnotationStore
(types named by the model's ``nuc_type_dict``), QuPath JSON, or a zarr
group holding them as JSON attributes; patch mode keeps ``"dict"`` only.

Every copy to the host is a drain (``parallel/pipeline.py``): queued on the
device's copy stream after the kernels that wrote the plane, into pinned
memory, and marked row chunk by row chunk by a waiter thread; on a card
``prepare_device`` runs before the loop, so that dispatching the drain
waits for none of the loop's queued work. The engine returns ``LazyRowsView``s of the filling buffers at once, and
``post_process_wsi`` hands them to a model with ``postproc_accepts_views``
(HoVerNet labels the foreground of the uint8 plane while the energy is
still on its way) and materialises them for any other. JAX's
``drain_during_loop`` (row blocks drained while later bands are still
scattered) is a run parameter here with no effect: the drain always runs,
and JAX itself drains one whole-canvas block.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tiatoolbox_tpu_torch import logger
from tiatoolbox_tpu_torch.models.engine.semantic_segmentor import (
    SemanticSegmentor,
    SemanticSegmentorRunParams,
    add_patches,
    spill_bytes,
)
from tiatoolbox_tpu_torch.ops.canvas import DeviceCanvas, normalize_rows
from tiatoolbox_tpu_torch.parallel import BatchLoader
from tiatoolbox_tpu_torch.parallel.pipeline import (
    BlockDrain,
    LazyRowsView,
    RowWatermark,
    fetch_chunked_async,
    prepare_device,
)
from tiatoolbox_tpu_torch.tools.patchextraction import PatchExtractor
from tiatoolbox_tpu_torch.utils.profiling import StageTimer
from tiatoolbox_tpu_torch.utils.zarrlite import ZarrArray, ZarrGroup


def drain_stage(watermark: RowWatermark, items: int, flushed: float, postproc_start: float) -> dict:
    """One drain's stage entry, from ``time.perf_counter()`` readings.

    ``seconds``: from the drain's start (its pinned allocation included) to
    its last row landed; ``after_flush_seconds``: from the flush (every copy
    of the fetch queued but the banded path's energy) to that last row;
    ``landed_after_postproc_start_seconds``: from the start of
    post-processing to that last row, and ``overlapped_with_postproc``
    whether it is positive, that is, whether post-processing started while
    rows were still on their way.
    """
    landed = watermark.finished_at - postproc_start
    return {
        "seconds": round(watermark.drain_seconds, 4),
        "after_flush_seconds": round(watermark.finished_at - flushed, 4),
        "landed_after_postproc_start_seconds": round(landed, 4),
        "items": items,
        "overlapped_with_postproc": landed > 0,
    }


class MultiTaskSegmentorRunParams(SemanticSegmentorRunParams, total=False):
    """``MultiTaskSegmentor.run`` keyword arguments (JAX ``multi_task_segmentor.py:28-30``, with keys).

    ``drain_during_loop`` (JAX: drain finished row blocks of the canvas
    while the loop runs) is accepted so that a JAX caller's ``run`` works,
    and has no effect: the port's drain always runs, its fetch copied on a
    CUDA copy stream while the host post-processes.
    """

    return_predictions: bool
    drain_during_loop: bool


class MultiTaskSegmentor(SemanticSegmentor):
    """Engine for multi-head models that produce instance segmentations.

    The model's ``infer_batch_device`` returns a tuple of per-head maps
    (HoVerNet: np, hv[, tp]) and its ``postproc`` maps the merged head maps
    to instance results. Run parameters add ``return_predictions`` (also
    return the stitched head maps); ``tile_shape``, ``margin`` and
    ``full_postproc_limit`` are attributes, as in JAX.
    """

    def __init__(
        self,
        model,
        weights=None,
        batch_size: int = 8,
        num_loader_workers: int = 8,
        device: str | None = None,
        *,
        verbose: bool = True,
    ) -> None:
        super().__init__(
            model=model,
            weights=weights,
            batch_size=batch_size,
            num_loader_workers=num_loader_workers,
            device=device,
            verbose=verbose,
        )
        self.tile_shape = (2048, 2048)
        self.margin = 128
        self.full_postproc_limit = 4096 * 4096  # pixels; a larger canvas goes tile by tile
        self.return_predictions = False
        # the drains of the last device canvas: ``{"since": flush time, stage: (watermark, items)}``
        self._pending_fetch: dict | None = None

    _RUN_PARAMS = tuple(MultiTaskSegmentorRunParams.__annotations__)

    # -- inference and merge --------------------------------------------------------

    def infer_wsi(self, dataloader: BatchLoader) -> dict:
        """Stitch every head into canvases and return ``{"head_maps", "canvas_wh"}`` (:74)."""
        self._pending_fetch = None
        dataset = dataloader.dataset
        ioconfig = self._ioconfig
        out_res = (
            ioconfig.output_resolutions[0]
            if ioconfig.output_resolutions
            else ioconfig.highest_input_resolution
        )
        canvas_wh = dataset.reader.slide_dimensions(out_res["resolution"], out_res["units"])
        read_wh = np.array(
            dataset.reader.slide_dimensions(dataset.resolution, dataset.units), dtype=float
        )
        coord_scale = np.array(canvas_wh, dtype=float) / read_wh
        probe = self._probe_output(dataset)
        if not isinstance(probe, (tuple, list)):
            probe = (probe,)
        head_channels = [int(np.asarray(p).shape[-1]) for p in probe]
        if self._can_use_multihead_device_canvas(dataset, canvas_wh, head_channels, coord_scale, probe):
            return self._infer_wsi_device_canvas_multihead(
                dataloader, canvas_wh, head_channels, coord_scale, probe
            )
        return self._infer_wsi_host_multihead(dataloader, canvas_wh, head_channels, coord_scale)

    def _infer_wsi_host_multihead(self, dataloader, canvas_wh, head_channels, coord_scale) -> dict:
        """Fetch each batch's heads and add them into canvases in RAM or zarr (:105-206)."""
        dataset = dataloader.dataset
        w, h = int(canvas_wh[0]), int(canvas_wh[1])
        canvases = [self._host_array((h, w, c), f"head{i}") for i, c in enumerate(head_channels)]
        count = self._host_array((h, w, 1), "count")
        outputs_arr = dataset.outputs
        timer = StageTimer()
        t_loop = time.perf_counter()
        wire = self._wire_dtype()
        pin = self.model.device.type == "cuda"
        for batch in dataloader.iter_staged(self.model.stage_batch, pin_memory=pin):
            heads = self.model.infer_batch_device(self.model, batch["image"])
            if not isinstance(heads, (tuple, list)):
                heads = (heads,)
            heads = [head.to(wire).cpu().numpy().astype(np.float32) for head in heads]
            out_hw = heads[0].shape[1:3]
            items = []
            for i, ds_idx in enumerate(batch["indices"][: batch["n_valid"]]):
                oc = outputs_arr[ds_idx].astype(float)
                # the model's output centred in its output grid cell
                off_x = (oc[2] - oc[0] - out_hw[1]) / 2
                off_y = (oc[3] - oc[1] - out_hw[0]) / 2
                x0 = int(round((oc[0] + off_x) * coord_scale[0]))
                y0 = int(round((oc[1] + off_y) * coord_scale[1]))
                sx0, sy0 = max(0, -x0), max(0, -y0)
                cx1, cy1 = min(x0 + out_hw[1], w), min(y0 + out_hw[0], h)
                cx0, cy0 = max(x0, 0), max(y0, 0)
                if cx1 <= cx0 or cy1 <= cy0:
                    continue
                patches = [head[i][sy0 : sy0 + (cy1 - cy0), sx0 : sx0 + (cx1 - cx0)] for head in heads]
                items.append((cy0, cy1, cx0, cx1, patches))
            add_patches(canvases, count, items, band_rows=2 * out_hw[0])
        timer.add("feed+forward+fetch+stitch", time.perf_counter() - t_loop)
        with timer.stage("normalize"):
            block = 2048
            for y0 in range(0, h, block):
                n = np.maximum(count[y0 : y0 + block], 1.0)
                for canvas in canvases:
                    canvas[y0 : y0 + block] = canvas[y0 : y0 + block] / n
        summary = timer.summary()
        summary["path"] = "multitask-host-stitch"
        self.spill_bytes = spill_bytes(*canvases, count)
        self._finish(summary)
        return {"head_maps": canvases, "canvas_wh": canvas_wh}

    def _multihead_positions(self, dataset, probe, coord_scale) -> np.ndarray:
        """Canvas (y, x) of every patch: the model output centred in its output cell (:210)."""
        out_hw = np.asarray(probe[0]).shape[1:3]
        oc = dataset.outputs.astype(float)
        off_x = (oc[:, 2] - oc[:, 0] - out_hw[1]) / 2
        off_y = (oc[:, 3] - oc[:, 1] - out_hw[0]) / 2
        x0 = np.round((oc[:, 0] + off_x) * coord_scale[0]).astype(np.int32)
        y0 = np.round((oc[:, 1] + off_y) * coord_scale[1]).astype(np.int32)
        return np.stack([y0, x0], axis=-1)

    def _can_use_multihead_device_canvas(self, dataset, canvas_wh, head_channels, coord_scale, probe) -> bool:
        """Every head at one scale, the canvas within the device budget, no negative position (:221)."""
        if len({np.asarray(p).shape[1:3] for p in probe}) != 1:
            return False
        n_pixels = int(canvas_wh[0]) * int(canvas_wh[1])
        if n_pixels * (sum(head_channels) + 1) * 4 > self._device_canvas_budget_bytes():
            return False
        return bool(self._multihead_positions(dataset, probe, coord_scale).min() >= 0)

    def _infer_wsi_device_canvas_multihead(
        self, dataloader: BatchLoader, canvas_wh, head_channels, coord_scale, probe
    ) -> dict:
        """All heads in one device canvas, fed by bands or per patch (:236-427)."""
        dataset = dataloader.dataset
        if self.model.device.type == "cuda":
            prepare_device(self.model.device)  # not behind the loop's queued forwards
        ph, pw = np.asarray(probe[0]).shape[1:3]
        positions_all = self._multihead_positions(dataset, probe, coord_scale)
        pad_h = max(int(canvas_wh[1]), int(positions_all[:, 0].max()) + ph)
        pad_w = max(int(canvas_wh[0]), int(positions_all[:, 1].max()) + pw)
        canvas = DeviceCanvas((pad_h, pad_w), sum(head_channels), device=self.model.device)
        timer = StageTimer()

        def run_batch(images, indices, n_valid: int, batch_size: int) -> None:
            heads = self.model.infer_batch_device(self.model, images)
            if not isinstance(heads, (tuple, list)):
                heads = (heads,)
            positions = np.zeros((batch_size, 2), np.int32)
            positions[:n_valid] = positions_all[indices[:n_valid]]
            canvas.add(torch.cat(heads, dim=-1), positions, np.arange(batch_size) < n_valid)

        plan = self._region_feed_plan(dataset)
        h, w = int(canvas_wh[1]), int(canvas_wh[0])
        full_canvas_postproc = (
            h * w <= self.full_postproc_limit
            and not self.return_predictions
            # a caller's postproc_func expects the raw head maps
            and getattr(self.model, "_postproc_func", None) is None
        )
        banded = (
            plan is not None
            and full_canvas_postproc
            and hasattr(self.model, "banded_fetch_spec")
            and self.model.banded_fetch_spec(head_channels)
        )

        t_loop = time.perf_counter()
        if plan is not None:
            for idx, patches, n_valid, _band_i in self._iter_band_batches(
                dataset, plan, timer, self.batch_size
            ):
                run_batch(patches, idx, n_valid, self.batch_size)
            path_name = "multitask-device-canvas+region-feed"
            wire_pixels = plan.wire_pixels
        else:
            pin = self.model.device.type == "cuda"
            wire_pixels = 0
            for batch in dataloader.iter_staged(self.model.stage_batch, pin_memory=pin):
                wire_pixels += int(np.prod(batch["image"].shape[:3]))
                run_batch(
                    batch["image"], np.asarray(batch["indices"]), batch["n_valid"],
                    batch["image"].shape[0],
                )
            path_name = "multitask-device-canvas"
        timer.add("dispatch-wall", time.perf_counter() - t_loop)

        pending: dict = {}
        if banded:
            # JAX's one whole-canvas block (:292-300): K6 packs the uint8 plane
            # and reduces the hv pair's min/max over the whole canvas, which K5
            # takes. The plane's copy is queued first, so the host labels the
            # foreground (``_proc_np_energy``) while the energy is on its way.
            fetch_state: dict = {}

            def block_fn(y0: int, rows: int) -> torch.Tensor:
                # ``state``: whatever the model's first hook hands its second
                # (``banded_fetch_spec``); the engine only passes it on
                plane, fetch_state["state"] = self.model.block_fetch_transform(
                    canvas.canvas[y0:], canvas.count[y0:], rows, w, head_channels
                )
                return plane

            with timer.stage("fetch-dispatch"):
                drain = BlockDrain(block_fn, n_rows=h, out_shape=(h, w, 1), out_dtype=np.uint8, block_h=h)
                drain.flush()
                since = time.perf_counter()
                energy = self.model.final_fetch_transform(
                    canvas.canvas, canvas.count, h, w, head_channels, fetch_state["state"],
                    dtype=self._wire_dtype(),
                )
                ebuf, ewm = fetch_chunked_async(energy, dtype=np.float32)
            head_maps = [
                LazyRowsView(drain.buf, drain.watermark, slice(0, 1)),
                LazyRowsView(ebuf, ewm, slice(0, 1)),
            ]
            pending = {"fetch-banded": (drain.watermark, h * w), "fetch": (ewm, h * w)}
            path_name += "+banded-u8+device-energy"
        else:
            fetch_channels = head_channels
            with timer.stage("fetch-dispatch"):
                transformed = None
                transform = getattr(self.model, "transform_canvas_for_postproc", None)
                if transform is not None and full_canvas_postproc:
                    normalized = normalize_rows(canvas.canvas, canvas.count, 0, h, w)
                    transformed = transform(normalized, head_channels)
                if transformed is not None:
                    dev_final, fetch_channels = transformed
                    buf, watermark = fetch_chunked_async(dev_final.to(self._wire_dtype()), dtype=np.float32)
                    path_name += "+device-energy"
                else:
                    buf, watermark = self._fetch_canvas_async(canvas, h, w)
                since = time.perf_counter()
            bounds = np.cumsum([0, *fetch_channels])
            head_maps = [LazyRowsView(buf, watermark, slice(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]
            pending = {"fetch": (watermark, h * w * int(bounds[-1]))}
        self._pending_fetch = {"since": since, **pending}
        summary = timer.summary()
        summary["path"] = path_name
        summary["wire_pixels"] = wire_pixels
        # the band feed's wire, as JAX reports it on either feed (:368, :422)
        summary["band_wire"] = getattr(self, "_resolved_band_wire", self.band_wire)
        if plan is not None:
            summary["n_bands"] = len(plan.bands)
        self._finish(summary)
        return {"head_maps": head_maps, "canvas_wh": canvas_wh}

    # -- instance post-processing ---------------------------------------------------

    def post_process_patches(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Each patch's head maps through the model's ``postproc_func`` (:431)."""
        heads = raw_predictions["probabilities"]
        if not isinstance(heads, (tuple, list)):
            heads = [heads]
        instances = []
        for i in range(len(heads[0])):
            results = self.model.postproc_func([np.asarray(head[i]) for head in heads])
            instances.append(self._results_to_instance_dict(results, offset=(0, 0)))
        raw_predictions["instances"] = instances
        return raw_predictions

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Instances of the whole map, or tile by tile above ``full_postproc_limit`` (:449-490).

        A device canvas arrives as ``LazyRowsView``s of buffers that are still
        filling. A model with ``postproc_accepts_views`` (and no caller's
        ``postproc_func``) gets them as they are and reads them in its own
        order; any other gets them materialised. Tile mode slices them, so
        each tile waits only for its rows. Afterwards each drain's time goes
        into the stage summary (``drain_stage``): ``"fetch"`` and the banded
        path's ``"fetch-banded"``.
        """
        head_maps = raw_predictions["head_maps"]
        canvas_wh = raw_predictions["canvas_wh"]
        pending, self._pending_fetch = self._pending_fetch, None
        semantic: dict = {}
        if hasattr(self.model, "last_postproc_seconds"):
            self.model.last_postproc_seconds = None  # accumulated over one run
        t0 = time.perf_counter()
        if canvas_wh[0] * canvas_wh[1] <= self.full_postproc_limit:
            if (
                getattr(self.model, "postproc_accepts_views", False)
                and getattr(self.model, "_postproc_func", None) is None
            ):
                maps = list(head_maps)
            else:
                maps = [np.asarray(m) for m in head_maps]
            results = self.model.postproc_func(maps)
            instances = self._results_to_instance_dict(results, offset=(0, 0))
            for task in results:
                if task.get("seg_type") == "semantic" and "predictions" in task:
                    semantic[task["task_type"]] = np.asarray(task["predictions"])
        else:
            instances, semantic = self._process_tile_mode(head_maps, canvas_wh)
        if pending is not None:
            since = pending.pop("since")
            for name, (watermark, items) in pending.items():
                watermark.wait_all()  # post-processing has read every row already
                if self.last_stage_summary is not None:
                    self.last_stage_summary[name] = drain_stage(watermark, items, since, t0)
        if self.last_stage_summary is not None:
            self.last_stage_summary["instance-postproc"] = {
                "seconds": round(time.perf_counter() - t0, 4)
            }
            for name, secs in (getattr(self.model, "last_postproc_seconds", None) or {}).items():
                self.last_stage_summary[name] = {"seconds": round(secs, 4)}
        out = {"instances": instances, "canvas_wh": canvas_wh}
        if semantic:
            out["semantic_predictions"] = semantic
        if self.return_predictions:
            out["predictions"] = [np.asarray(m) for m in head_maps]
        return out

    # -- the reference's 4-pass tile scheme -------------------------------------------

    @staticmethod
    def _boxes_intersect(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
        """Inclusive box-against-box intersection (shapely STRtree.query semantics)."""
        if len(boxes) == 0:
            return np.zeros(0, dtype=bool)
        return (
            (boxes[:, 0] <= query[2])
            & (boxes[:, 2] >= query[0])
            & (boxes[:, 1] <= query[3])
            & (boxes[:, 3] >= query[1])
        )

    @staticmethod
    def _boxes_contained(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
        """Boxes fully within ``query`` (shared edges allowed)."""
        if len(boxes) == 0:
            return np.zeros(0, dtype=bool)
        return (
            (boxes[:, 0] >= query[0])
            & (boxes[:, 1] >= query[1])
            & (boxes[:, 2] <= query[2])
            & (boxes[:, 3] <= query[3])
        )

    def _get_tile_info(self, image_shape) -> list:
        """Four tile sets with per-side removal flags (:531; reference :1362-1553).

        Returns ``[[boxes, flags], ...]`` for (0) grid tiles, (1) vertical
        boundary strips, (2) horizontal boundary strips and (3)
        cross-section tiles. Flag columns are [top, bottom, left, right];
        1 removes the instances in that side's margin (a later pass owns
        them), and sides on the slide's boundary are unset.
        """
        margin = self.margin
        w, h = int(image_shape[0]), int(image_shape[1])
        tile_shape = np.array(self.tile_shape, dtype=np.int32)
        boxes = PatchExtractor.get_coordinates(
            image_shape=(w, h),
            patch_input_shape=tuple(tile_shape),
            stride_shape=tuple(tile_shape),
        ).astype(np.int64)
        if w <= tile_shape[0] and h <= tile_shape[1]:
            return [[boxes, np.zeros((boxes.shape[0], 4), dtype=np.int32)]]
        edge_lines = (
            np.array([0, 0, w, 0]),
            np.array([0, h, w, h]),
            np.array([0, 0, 0, h]),
            np.array([w, 0, w, h]),
        )

        def unset_boundary(tile_boxes: np.ndarray, flags: np.ndarray) -> np.ndarray:
            for idx, line in enumerate(edge_lines):
                flags[self._boxes_intersect(tile_boxes, line), idx] = 0
            return flags

        flag = unset_boundary(boxes, np.ones((boxes.shape[0], 4), np.int32))
        info = [[boxes, flag]]
        # vertical strips around removed right edges: top and bottom flagged
        sel = np.nonzero(flag[:, 3])[0]
        v_boxes = np.stack(
            [boxes[sel, 2] - margin, boxes[sel, 1], boxes[sel, 2] + margin, boxes[sel, 3]], axis=-1
        )
        v_flag = np.zeros((v_boxes.shape[0], 4), np.int32)
        v_flag[:, [0, 1]] = 1
        info.append([v_boxes, unset_boundary(v_boxes, v_flag)])
        # horizontal strips around removed bottom edges: left and right flagged
        sel = np.nonzero(flag[:, 1])[0]
        h_boxes = np.stack(
            [boxes[sel, 0], boxes[sel, 3] - margin, boxes[sel, 2], boxes[sel, 3] + margin], axis=-1
        )
        h_flag = np.zeros((h_boxes.shape[0], 4), np.int32)
        h_flag[:, [2, 3]] = 1
        info.append([h_boxes, unset_boundary(h_boxes, h_flag)])
        # cross-sections at removed bottom-right corners: every side flagged
        sel = np.nonzero(flag[:, 1] * flag[:, 3])[0]
        x_boxes = np.stack(
            [
                boxes[sel, 2] - 2 * margin,
                boxes[sel, 3] - 2 * margin,
                boxes[sel, 2] + 2 * margin,
                boxes[sel, 3] + 2 * margin,
            ],
            axis=-1,
        )
        info.append([x_boxes, np.ones((x_boxes.shape[0], 4), np.int32)])
        return info

    def _select_tile_removals(self, inst_boxes: np.ndarray, tile_wh, tile_flag, tile_mode: int) -> np.ndarray:
        """Instances to drop within one tile (:613; reference :2952-3013).

        Modes 0 and 3 drop instances inside a flagged margin; modes 1 and 2
        drop instances that cross a flagged margin or touch an unflagged
        tile boundary.
        """
        width, height = tile_wh
        margin = self.margin
        boundary_lines = (
            np.array([0, 0, width, 1]),
            np.array([0, height - 1, width, height]),
            np.array([0, 0, 1, height]),
            np.array([width - 1, 0, width, height]),
        )
        margin_boxes = (
            np.array([0, 0, width, margin]),
            np.array([0, height - margin, width, height]),
            np.array([0, 0, margin, height]),
            np.array([width - margin, 0, width, height]),
        )
        removal = np.zeros(len(inst_boxes), dtype=bool)
        if tile_mode in (0, 3):
            for idx in range(4):
                if tile_flag[idx] or tile_mode == 3:
                    removal |= self._boxes_contained(inst_boxes, margin_boxes[idx])
        else:
            for idx in range(4):
                query = margin_boxes[idx] if tile_flag[idx] else boundary_lines[idx]
                removal |= self._boxes_intersect(inst_boxes, query)
        return removal

    def _margin_lines(self, tile_box) -> list:
        """The tile's inset margin lines in slide space (:651; reference :3014-3028)."""
        x0, y0, x1, y1 = (int(v) for v in tile_box)
        width, height = x1 - x0, y1 - y0
        m = self.margin
        lines = [
            [m, m, width - m, m],
            [m, height - m, width - m, height - m],
            [m, m, m, height - m],
            [width - m, m, width - m, height - m],
        ]
        return [np.array(line) + np.array([x0, y0, x0, y0]) for line in lines]

    def _process_tile_mode(self, head_maps, canvas_wh) -> tuple[dict, dict]:
        """The 4-pass tile post-processing with margin-flag deduplication (:664).

        Tiles are post-processed on worker threads (the watershed and the
        contour follower release the interpreter lock in C++) and merged in
        order; pass 3 also evicts earlier instances cut by its margin lines.
        """
        w, h = int(canvas_wh[0]), int(canvas_wh[1])
        instances: dict = {}
        semantic: dict = {}

        def compute_tile(job):
            tile_box, tile_flag = job
            # the slice is clipped to the canvas; removals use the nominal box
            nx0, ny0, nx1, ny1 = (int(v) for v in tile_box)
            x0, y0 = max(nx0, 0), max(ny0, 0)
            x1, y1 = min(nx1, w), min(ny1, h)
            if x1 <= x0 or y1 <= y0:
                return None
            results = self.model.postproc_func([np.asarray(m[y0:y1, x0:x1]) for m in head_maps])
            tile_instances = self._results_to_instance_dict(results, offset=(x0 - nx0, y0 - ny0))
            return tile_flag, (nx0, ny0, nx1, ny1), (x0, y0, x1, y1), results, tile_instances

        n_workers = max(1, min(8, (os.cpu_count() or 2) - 1))
        with ThreadPoolExecutor(n_workers) as pool:
            for tile_mode, (boxes, flags) in enumerate(self._get_tile_info((w, h))):
                jobs = list(zip(boxes, flags))
                # at most 2 * n_workers tile results resident at once
                window = 2 * n_workers
                for b0 in range(0, len(jobs), window):
                    for computed in pool.map(compute_tile, jobs[b0 : b0 + window]):
                        if computed is None:
                            continue
                        tile_flag, nominal, clipped, results, tile_instances = computed
                        self._merge_tile_results(
                            instances, semantic, results, tile_instances,
                            tile_flag, tile_mode, nominal, clipped, (w, h),
                        )
        return instances, semantic

    def _merge_tile_results(  # noqa: PLR0913
        self, instances, semantic, results, tile_instances, tile_flag, tile_mode, nominal, clipped, canvas_wh
    ) -> None:
        """Merge one tile's results, in order (:727)."""
        nx0, ny0, nx1, ny1 = nominal
        x0, y0, x1, y1 = clipped
        w, h = canvas_wh
        if tile_mode == 0:
            # grid tiles cover the canvas: semantic maps are written whole
            for task in results:
                if task.get("seg_type") != "semantic" or "predictions" not in task:
                    continue
                pred = np.asarray(task["predictions"])
                name = task["task_type"]
                if name not in semantic:
                    semantic[name] = self._host_array((h, w), f"semantic_{name}", pred.dtype)
                semantic[name][y0:y1, x0:x1] = pred[: y1 - y0, : x1 - x0]
        if not tile_instances:
            return
        keys = list(tile_instances)
        inst_boxes = np.array([np.asarray(tile_instances[k]["box"], float) for k in keys])
        removal = self._select_tile_removals(inst_boxes, (nx1 - nx0, ny1 - ny0), tile_flag, tile_mode)
        if tile_mode == 3 and instances:
            acc_keys = list(instances)
            acc_boxes = np.array([np.asarray(instances[k]["box"], float) for k in acc_keys])
            evict = np.zeros(len(acc_keys), dtype=bool)
            for line in self._margin_lines((nx0, ny0, nx1, ny1)):
                evict |= self._boxes_intersect(acc_boxes, line)
            for k in np.asarray(acc_keys)[evict]:
                instances.pop(k, None)
        offset = np.array([nx0, ny0])
        for k, keep in zip(keys, ~removal):
            if not keep:
                continue
            info = tile_instances[k]
            info["box"] = np.asarray(info["box"]) + np.tile(offset, 2)
            info["centroid"] = np.asarray(info["centroid"]) + offset
            info["contours"] = np.asarray(info["contours"]) + offset
            instances[k] = info

    @staticmethod
    def _results_to_instance_dict(results, offset=(0, 0)) -> dict:
        """Model post-processing output -> ``{uuid: instance info}`` (:789)."""
        instances = {}
        offset = np.asarray(offset)
        for task in results:
            info_dict = task.get("info_dict", {})
            boxes = info_dict.get("box", [])
            for i in range(len(boxes)):
                instances[str(uuid.uuid4())] = {
                    "box": np.asarray(boxes[i]) + np.tile(offset, 2),
                    "centroid": np.asarray(info_dict["centroid"][i]) + offset,
                    "contours": np.asarray(info_dict["contours"][i]) + offset,
                    "prob": info_dict["prob"][i],
                    "type": info_dict["type"][i],
                    "task_type": task.get("task_type"),
                }
        return instances

    def save_predictions(
        self,
        processed_predictions: dict,
        output_type: str,
        save_dir=None,
        output_file: str | None = None,
        **kwargs,
    ):
        """Return the dict, or write the instances as an AnnotationStore,
        QuPath JSON or zarr under ``save_dir`` and return the path (:811-875).

        A dict's spilled semantic maps are read into RAM before their cache
        is removed (JAX returns zarr arrays of the removed cache).
        """
        instances = processed_predictions.get("instances", {})
        kind = output_type.lower()
        if kind == "dict":
            semantic = processed_predictions.get("semantic_predictions")
            if semantic:
                processed_predictions = {
                    **processed_predictions,
                    "semantic_predictions": {
                        k: np.asarray(v) if isinstance(v, ZarrArray) else v for k, v in semantic.items()
                    },
                }
            return processed_predictions
        if isinstance(instances, list):  # patch mode: per-patch dicts
            msg = (
                "Patch-mode multi-task outputs support output_type='dict'; "
                "merge or save per-patch instance dicts downstream."
            )
            raise ValueError(msg)
        if save_dir is None:
            msg = f"`save_dir` must be provided for output_type={output_type}."
            raise ValueError(msg)
        from tiatoolbox_tpu_torch.utils.store_conversion import (
            dict_to_store_instance_segmentor,
            store_to_qupath_json,
        )

        scale_factor = kwargs.get("scale_factor", (1.0, 1.0))
        if kind == "annotationstore":
            class_dict = getattr(self.model, "nuc_type_dict", None) or self.class_dict
            return dict_to_store_instance_segmentor(
                instances,
                scale_factor=scale_factor,
                class_dict=class_dict,
                save_path=Path(save_dir) / (output_file or "output.db"),
            )
        if kind == "qupath":
            store = dict_to_store_instance_segmentor(instances, scale_factor=scale_factor)
            return store_to_qupath_json(store, Path(save_dir) / (output_file or "output.json"))
        if kind == "zarr":
            out_path = Path(save_dir) / (output_file or "output.zarr")
            group = ZarrGroup.create(out_path)
            serializable = {
                key: {
                    "box": np.asarray(info["box"]).tolist(),
                    "centroid": np.asarray(info["centroid"]).tolist(),
                    "contours": np.asarray(info["contours"]).tolist(),
                    "prob": info["prob"],
                    "type": int(info["type"]) if info["type"] is not None else None,
                }
                for key, info in instances.items()
            }
            group.attrs = {"instances": json.loads(json.dumps(serializable))}
            return out_path
        msg = f"Unsupported output_type: {output_type}"
        raise ValueError(msg)


class NucleusInstanceSegmentor(MultiTaskSegmentor):
    """Deprecated alias of ``MultiTaskSegmentor`` (:879)."""

    def __init__(self, *args, **kwargs) -> None:
        logger.warning("NucleusInstanceSegmentor is deprecated; use MultiTaskSegmentor.")
        super().__init__(*args, **kwargs)
