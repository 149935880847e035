"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc (one process per source, all at
once), writes synthetic deflate pyramidal slides to a temporary directory,
and drives the port's entry points on them:

- A, stain normalisation: get_normalizer("macenko") -> fit(target) ->
  prepare_tile_transform(thumbnail) -> transform_tiles(batch) over every
  224x224 patch batch of a 4096x3072 slide at 0.5 mpp (the stain kernel);
- B, whole-slide patch classification: PatchPredictor with a seeded
  resnet18 CNNModel (9 classes, full width and depth, batch-norm statistics
  taken from the slide's first batch of patches) over the same slide with
  the kather100k ioconfig and the Otsu tissue mask;
- C ("segment"), whole-slide semantic segmentation: SemanticSegmentor with
  get_pretrained_model("fcn_resnet50_unet-bcss") (full width and depth,
  seeded weights, batch-norm statistics from the first batch, batch 16)
  over a 6144x4608 slide at 0.25 mpp, once through the region feed (bands
  read once, patches cut on the card) and once per patch with the Otsu
  mask; both stitch on the card (the canvas kernels).

Each phase prints one JSON line. The stain kernel is held against its plain
PyTorch version on the card (main-path batch, all 2^24 RGB colours, ragged
and misaligned inputs); the canvas and band kernels are held against theirs
bit for bit (real shapes, ragged cases, and each segment run stitched again
by the plain versions); every kernel is timed beside its plain version, a
library call where one computes the same function, and its byte bound. The
classifier's and the U-Net's first batch are held against the same model on
the CPU, and one bfloat16 U-Net batch against float32. The script prints a
"kernels" line, the card's name and power limit, and last the result line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero; it also exits non-zero, printing no result, where CUDA is not
available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tiatoolbox_tpu_torch import PRETRAINED_MODELS, _build  # noqa: E402
from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel  # noqa: E402
from tiatoolbox_tpu_torch.models.dataset import WSIPatchDataset  # noqa: E402
from tiatoolbox_tpu_torch.models.engine import SemanticSegmentor  # noqa: E402
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig  # noqa: E402
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor  # noqa: E402
from tiatoolbox_tpu_torch.models.models_abc import ModelABC  # noqa: E402
from tiatoolbox_tpu_torch.ops import canvas as canvas_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import region as region_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops.stain import (  # noqa: E402
    stain_transform,
    stain_transform_reference,
)
from tiatoolbox_tpu_torch.parallel import BatchLoader  # noqa: E402
from tiatoolbox_tpu_torch.tools.stainnorm import get_normalizer  # noqa: E402
from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader  # noqa: E402

BATCH = 64
PATCH = 224
SLIDE_WH = (4096, 3072)
# Published peaks of one H100 SXM (the port's records use these for bounds).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Per pixel the stain transform reads 3 bytes and writes 3, and does 3 log,
# 3 exp and about 40 other float32 operations.
STAIN_BYTES_PER_PIX = 6
STAIN_OPS_PER_PIX = 46


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up call.

    The stream first spins for a while, so that the host has queued every
    call before the first one starts: the events then time the device work
    back to back, without the host's launch gaps.
    """
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_env() -> str:
    t0 = time.perf_counter()
    card = card_name_and_limit()
    emit(
        {
            "phase": "env",
            "seconds": time.perf_counter() - t0,
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": card,
        }
    )
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
            "ptxas": {k: _build.ptxas_report(k) for k in libs},
        }
    )


def phase_slide(tmp: Path) -> Path:
    t0 = time.perf_counter()
    path = make_synthetic_slide(tmp / "slide.tiff", size=SLIDE_WH, mpp=0.5, objective_power=20)
    info = WSIReader.open(path).info
    check(tuple(info.slide_dimensions) == SLIDE_WH, "slide dimensions")
    emit(
        {
            "phase": "slide",
            "seconds": time.perf_counter() - t0,
            "dimensions": list(info.slide_dimensions),
            "levels": info.level_count,
            "bytes": path.stat().st_size,
        }
    )
    return path


def held_against_plain(got: torch.Tensor, tiles: torch.Tensor, args, what: str) -> tuple[int, float]:
    """Max abs difference and identical share of the kernel's ``got`` against
    the plain version on ``tiles``; fails past 1 level or under 99.9 %."""
    ref = stain_transform_reference(tiles, *args)
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)}")
    diff = (got.int() - ref.int()).abs()
    max_err = int(diff.max())
    identical = float((diff == 0).double().mean())
    check(max_err <= 1, f"{what}: kernel vs plain max abs diff {max_err} > 1")
    check(identical >= 0.999, f"{what}: kernel vs plain identical share {identical} < 0.999")
    return max_err, identical


def all_colours() -> torch.Tensor:
    """Every RGB triple once, as a [4096, 4096, 3] uint8 tensor on the card."""
    c = torch.arange(1 << 24, dtype=torch.int32, device="cuda")
    rgb = torch.stack([c >> 16, (c >> 8) & 255, c & 255], dim=-1)
    return rgb.to(torch.uint8).reshape(4096, 4096, 3)


def ragged_cases(batch: torch.Tensor) -> dict[str, torch.Tensor]:
    """Pixel counts around the kernel's 16-pixel lane step and 512-pixel warp
    step, and the batch as a contiguous view 3 bytes into a buffer (not
    16-byte aligned)."""
    rng = np.random.default_rng(11)
    cases = {
        f"{n}_pixels": torch.from_numpy(rng.integers(0, 256, (n, 3), dtype=np.uint8)).cuda()
        for n in (1, 15, 16, 17, 511, 512, 513, batch.numel() // 3 + 5)
    }
    buf = torch.empty(3 + batch.numel(), dtype=torch.uint8, device="cuda")
    buf[3:] = batch.flatten()
    cases["batch_3_bytes_into_a_buffer"] = buf[3:].view(batch.shape)
    check(cases["batch_3_bytes_into_a_buffer"].data_ptr() % 16 != 0, "misaligned view")
    return cases


def phase_stain(slide: Path) -> dict:
    t0 = time.perf_counter()
    dataset = WSIPatchDataset(
        slide,
        patch_input_shape=(PATCH, PATCH),
        stride_shape=(PATCH, PATCH),
        resolution=0.5,
        units="mpp",
        auto_get_mask=False,
    )
    loader = BatchLoader(dataset, batch_size=BATCH, num_workers=8)

    def to_card(host: torch.Tensor) -> torch.Tensor:
        return host.to("cuda", non_blocking=True)

    # main path, counted from zero
    stain_transform.launches = 0
    normalizer = get_normalizer("macenko")
    normalizer.fit(synthetic_he_patch((512, 512), seed=5))
    constants = normalizer.prepare_tile_transform(WSIReader.open(slide).slide_thumbnail())
    first_in = first_out = None
    n_patches = 0
    for batch in loader.iter_staged(to_card, pin_memory=True):
        out = normalizer.transform_tiles(batch["image"], constants)
        if first_in is None:
            first_in, first_out = batch["image"].clone(), out
        n_patches += batch["n_valid"]
    torch.cuda.synchronize()
    launches = stain_transform.launches
    seconds = time.perf_counter() - t0
    check(launches == len(loader) and launches > 0, f"stain launches {launches}")

    # kernel vs plain version on the card: the main path's batch, every
    # colour (so every entry of the kernel's OD table), ragged and misaligned
    args = (constants["conc_proj"], constants["target_stains"], constants["conc_scale"])
    check(tuple(first_out.shape) == (BATCH, PATCH, PATCH, 3), "stain output shape")
    max_err, identical = held_against_plain(first_out, first_in, args, "main path batch")
    colours = all_colours()
    sweep_err, sweep_identical = held_against_plain(
        stain_transform(colours, *args), colours, args, "2^24 colours"
    )
    ragged = {
        name: held_against_plain(stain_transform(tiles, *args), tiles, args, name)
        for name, tiles in ragged_cases(first_in).items()
    }
    torch.cuda.synchronize()

    # times: rotate over copies of the batch that together exceed the L2 cache
    copies = [first_in.clone() for _ in range(8)]
    turn = iter(range(1 << 30))
    kernel_ms = time_ms(lambda: stain_transform(copies[next(turn) % 8], *args), 50)
    plain_ms = time_ms(lambda: stain_transform_reference(copies[next(turn) % 8], *args), 20)
    # yardsticks: a device copy of the same bytes (one launch, no arithmetic),
    # and the kernel on 5.2 times the pixels (the 2^24 colours, 100 MB moved)
    copy_ms = time_ms(lambda: copies[next(turn) % 8].clone(), 50)
    sweep_ms = time_ms(lambda: stain_transform(colours, *args), 20)
    n_pix = first_in.numel() // 3
    bytes_s = STAIN_BYTES_PER_PIX * n_pix / HBM_BYTES_PER_S
    ops_s = STAIN_OPS_PER_PIX * n_pix / FP32_OPS_PER_S
    bound_ms = max(bytes_s, ops_s) * 1e3
    result = {
        "name": "stain_transform",
        "route": "cuda",
        "source": "tiatoolbox_tpu_torch/csrc/stain.cu",
        "replaces": "tiatoolbox_tpu/ops/stain.py:122",
        "launches": launches,
        "max_abs_err": max(max_err, sweep_err, *(e for e, _ in ragged.values())),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": None,
    }
    emit(
        {
            "phase": "stain",
            "seconds": seconds,
            "patches": n_patches,
            "batches": len(loader),
            "launches": launches,
            "max_abs_err": max_err,
            "identical_share": identical,
            "sweep_max_abs_err": sweep_err,
            "sweep_identical_share": sweep_identical,
            "ragged_max_abs_err_and_identical_share": ragged,
            "kernel_ms": kernel_ms,
            "kernel_mpix_per_s": n_pix / kernel_ms / 1e3,
            "kernel_gb_per_s": STAIN_BYTES_PER_PIX * n_pix / kernel_ms / 1e6,
            "share_of_bound": bound_ms / kernel_ms,
            "copy_ms": copy_ms,
            "sweep_kernel_ms": sweep_ms,
            "sweep_kernel_gb_per_s": STAIN_BYTES_PER_PIX * colours.numel() / 3 / sweep_ms / 1e6,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "batch_shape": list(first_in.shape),
        }
    )
    return result


def calibrate_batch_norm(model: ModelABC, images: np.ndarray) -> None:
    """Set every batch norm's statistics to those of ``images``.

    With torchvision's initialisation every batch norm is the identity, and
    the logits hardly depend on the input. One forward in training mode with
    a cumulative average puts the statistics of real patches in place, so
    the card-vs-CPU comparison below sees input-dependent outputs.
    """
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for norm in norms:
        norm.reset_running_stats()
        norm.momentum = None
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(images).to(model.device).float().div_(255.0))
    model.eval()
    for norm in norms:
        norm.momentum = 0.1


def phase_predict(slide: Path, card: str) -> None:
    # full float32 on the card, so the CPU comparison below holds at 1e-3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ioconfig = IOPatchPredictorConfig(
        **PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"]
    )
    t_grid = time.perf_counter()
    expected = WSIPatchDataset(
        slide,
        patch_input_shape=(PATCH, PATCH),
        stride_shape=(PATCH, PATCH),
        resolution=0.5,
        units="mpp",
    )
    grid_seconds = time.perf_counter() - t_grid
    n_first = min(BATCH, len(expected))
    check(n_first > 0, "the tissue mask keeps no patch")
    first = np.stack([expected[i]["image"] for i in range(n_first)])

    model = CNNModel("resnet18", num_classes=9, seed=0)
    check(model.device.type == "cuda", f"model built on {model.device}")
    calibrate_batch_norm(model, first)
    # warm-up: the first cuDNN call of a process initialises the library
    CNNModel.infer_batch(model, np.zeros((BATCH, PATCH, PATCH, 3), np.uint8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    predictor = PatchPredictor(model=model, batch_size=BATCH, verbose=False)
    output = predictor.run([slide], patch_mode=False, ioconfig=ioconfig)[str(slide)]
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    probs = output["probabilities"]
    check(len(probs) == len(expected), f"patch count {len(probs)} vs {len(expected)}")
    check(np.array_equal(output["coordinates"], expected.inputs), "patch coordinates")
    check(probs.shape == (len(expected), 9), f"probabilities shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "probabilities finite")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(row_err <= 1e-4, f"probability rows sum to 1 within {row_err}")
    check(np.array_equal(output["predictions"], probs.argmax(axis=1)), "predictions")

    # first batch against the same model, same weights, on the CPU
    cpu_model = CNNModel("resnet18", num_classes=9, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_probs = CNNModel.infer_batch(cpu_model, first)
    cpu_err = float(np.abs(cpu_probs - probs[:n_first]).max())
    check(cpu_err <= 1e-3, f"card vs CPU probabilities max abs diff {cpu_err} > 1e-3")
    with torch.inference_mode():
        card_logits = model.apply_u8(model.stage_batch(first)).cpu().double()
        cpu_logits = cpu_model.apply_u8(torch.from_numpy(first)).double()
    logit_err = float((card_logits - cpu_logits).abs().max())
    logit_scale = float(cpu_logits.abs().max())
    # the part of the logits that depends on the patch: a forward that
    # ignored its input would miss it by its own size
    logit_spread = float((cpu_logits - cpu_logits.mean(dim=0)).abs().max())
    check(
        logit_err <= 1e-4 * logit_scale,
        f"card vs CPU logits max abs diff {logit_err} > 1e-4 * max |logit| {logit_scale}",
    )
    check(
        logit_err <= 1e-3 * logit_spread,
        f"card vs CPU logits max abs diff {logit_err} > 1e-3 * patch spread {logit_spread}",
    )

    # the forward alone, on a batch already on the card
    on_card = torch.zeros((BATCH, PATCH, PATCH, 3), dtype=torch.uint8, device="cuda")
    on_card[:n_first] = torch.from_numpy(first).cuda()
    forward_ms = time_ms(lambda: CNNModel.infer_batch_device(model, on_card), 20)
    row_max = probs.max(axis=1)
    emit(
        {
            "phase": "predict",
            "seconds": seconds,
            "patches": int(len(probs)),
            "patches_per_s": len(probs) / seconds,
            "grid_and_mask_seconds": grid_seconds,
            "forward_ms_per_batch": forward_ms,
            "forward_patches_per_s": BATCH / forward_ms * 1e3,
            "peak_memory_bytes": int(peak),
            "row_sum_err": row_err,
            "cpu_max_abs_diff": cpu_err,
            "cpu_logit_max_abs_diff": logit_err,
            "logit_max_abs": logit_scale,
            "logit_patch_spread": logit_spread,
            "row_max_prob_min_median_max": [
                float(row_max.min()),
                float(np.median(row_max)),
                float(row_max.max()),
            ],
            "prob_std_over_patches": float(probs.std(axis=0).max()),
            "class_counts": np.bincount(output["predictions"], minlength=9).tolist(),
            "card": card,
        }
    )


# -- phase C: whole-slide semantic segmentation ---------------------------------

DEVICE = "cuda"
SEG_MODEL = "fcn_resnet50_unet-bcss"
SEG_SLIDE_WH = (6144, 4608)  # 0.25 mpp, 40x: 154 patches of 1024^2 at stride 450
SEG_BATCH = 16
# the per-patch run keeps the patches whose output cell is at least half tissue
SEG_MIN_MASK_RATIO = 0.5
SEG_KERNELS = {
    "scatter_accumulate": canvas_ops.scatter_accumulate,
    "normalize_rows": canvas_ops.normalize_rows,
    "extract_patches": region_ops.extract_patches,
}


def reset_segment_counts() -> None:
    for fn in SEG_KERNELS.values():
        fn.launches = 0


def segment_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in SEG_KERNELS.items()}


class CanvasRecorder:
    """Keeps the canvas and every ``DeviceCanvas.add``'s arguments of a run,
    so that the run can be stitched again with the plain versions. The
    patches go to pinned host slots, allocated before the run, with one
    asynchronous copy each: the card holds no more than the run itself."""

    def __init__(self, n_slots: int, batch_shape: tuple[int, ...]) -> None:
        pin = DEVICE == "cuda"
        self.slots = [torch.empty(batch_shape, pin_memory=pin) for _ in range(n_slots)]

    def __enter__(self) -> "CanvasRecorder":
        self.canvas = None
        self.calls: list = []
        self._add = add = canvas_ops.DeviceCanvas.add

        def recording_add(canvas, patches, positions, valid=None):
            add(canvas, patches, positions, valid)
            if self.canvas is None:
                self.canvas = canvas
            check(canvas is self.canvas, "one canvas per run")
            check(len(self.calls) < len(self.slots), "a recorder slot for every batch")
            slot = self.slots[len(self.calls)]
            check(tuple(patches.shape) == tuple(slot.shape), f"batch shape {tuple(patches.shape)}")
            slot.copy_(patches, non_blocking=True)
            self.calls.append((slot, np.array(positions), None if valid is None else np.array(valid)))

        canvas_ops.DeviceCanvas.add = recording_add
        return self

    def __exit__(self, *exc) -> None:
        canvas_ops.DeviceCanvas.add = self._add


def phase_segment_slide(tmp: Path) -> Path:
    t0 = time.perf_counter()
    path = make_synthetic_slide(
        tmp / "segment.tiff", size=SEG_SLIDE_WH, mpp=0.25, objective_power=40, seed=31
    )
    info = WSIReader.open(path).info
    check(tuple(info.slide_dimensions) == SEG_SLIDE_WH, "segment slide dimensions")
    emit(
        {
            "phase": "segment_slide",
            "seconds": time.perf_counter() - t0,
            "dimensions": list(info.slide_dimensions),
            "mpp": float(info.mpp[0]),
            "levels": info.level_count,
            "bytes": path.stat().st_size,
        }
    )
    return path


def temper_random_weights(model: UNetModel) -> None:
    """Scale each bottleneck's last batch norm to a fifth (torchvision's
    ``zero_init_residual`` sets it to zero) and the classifier to 0.3, so the
    seeded random network works at the scale of a trained one."""
    with torch.no_grad():
        for name, module in model.named_modules():
            if name.endswith("bn3"):
                module.weight.mul_(0.2)
        model.clf.weight.mul_(0.3)


def restitch_with_plain_versions(recorder: CanvasRecorder, fetched: np.ndarray) -> dict:
    """Stitch a run's recorded patch outputs again with the plain
    ``scatter_accumulate`` and ``normalize_rows`` on the card; the canvas,
    the count and the fetched map must equal the kernels' bit for bit."""
    device_canvas = recorder.canvas
    plain_c = torch.zeros_like(device_canvas.canvas)
    plain_n = torch.zeros_like(device_canvas.count)
    for probs, positions, valid in recorder.calls:
        probs = probs.to(DEVICE)
        ok = canvas_ops.in_range_mask(positions, valid, plain_c.shape[:2], probs.shape[1:3])
        canvas_ops.scatter_accumulate_reference(plain_c, plain_n, probs, positions, ok)
    h, w = fetched.shape[:2]
    plain_map = canvas_ops.normalize_rows_reference(plain_c, plain_n, 0, h, w).cpu()
    scatter_err = max(
        held_bitwise(device_canvas.canvas, plain_c, "kernel canvas == plain canvas"),
        held_bitwise(device_canvas.count, plain_n, "kernel count == plain count"),
    )
    map_err = held_bitwise(torch.from_numpy(fetched), plain_map, "kernel-normalised map == plain map")
    return {
        "batches": len(recorder.calls),
        "canvas_shape": list(plain_c.shape),
        "max_count": float(plain_n.max()),
        "scatter_max_abs_err": scatter_err,
        "normalize_max_abs_err": map_err,
    }


def run_segment_path(
    model: UNetModel, slide: Path, ioconfig, card: str, want_path: str, n_slots: int, **run_kwargs
) -> tuple[dict, CanvasRecorder, dict]:
    """One whole-slide run through ``SemanticSegmentor.run``, counted from zero.
    The peak device memory is the run's own: the caller holds nothing else
    on the card but the model and its first batch."""
    segmentor = SemanticSegmentor(model, batch_size=SEG_BATCH, verbose=False)
    recorder = CanvasRecorder(n_slots, (SEG_BATCH, *ioconfig.patch_output_shape, 5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_segment_counts()
    with recorder:
        t0 = time.perf_counter()
        output = segmentor.run([slide], patch_mode=False, ioconfig=ioconfig, **run_kwargs)
        seconds = time.perf_counter() - t0
    counts = segment_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    summary = segmentor.last_stage_summary
    check(summary["path"] == want_path, f"path {summary['path']} != {want_path}")
    result = output[str(slide)]
    probs, preds = result["probabilities"], result["predictions"]
    w, h = SEG_SLIDE_WH
    check(probs.shape == (h, w, 5) and probs.dtype == np.float32, f"map shape {probs.shape}")
    check(preds.shape == (h, w) and preds.dtype == np.uint8, f"predictions shape {preds.shape}")
    check(bool(np.isfinite(probs).all()), "probabilities finite")
    covered = probs.sum(axis=-1) > 0
    row_err = float(np.abs(probs.sum(axis=-1)[covered] - 1.0).max())
    check(row_err <= 1e-5, f"covered pixels' probabilities sum to 1 within {row_err}")
    check(np.array_equal(preds, probs.argmax(axis=-1)), "predictions are the argmax")
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    restitch = restitch_with_plain_versions(recorder, probs)
    line = {
        "phase": "segment",
        "path": summary["path"],
        "seconds": seconds,
        "patches": n_patches,
        "patches_per_s": n_patches / seconds,
        "slide_mpix_per_s": w * h / 1e6 / seconds,
        "covered_share": float(covered.mean()),
        "peak_memory_bytes": int(peak),
        "launches": counts,
        "n_bands": summary.get("n_bands"),
        "wire_pixels": summary["wire_pixels"],
        "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
        "restitch": restitch,
        "class_counts": np.bincount(preds.ravel(), minlength=5).tolist(),
        "card": card,
    }
    return line, recorder, counts


def _bound(n_bytes: float) -> float:
    """Milliseconds to move ``n_bytes`` at the card's published memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _covered_area(hw: tuple[int, int], pos: np.ndarray, ok: np.ndarray, patch_hw) -> int:
    mask = torch.zeros(hw, dtype=torch.bool, device=DEVICE)
    for (y, x), v in zip(pos.tolist(), ok.tolist()):
        if v:
            mask[y : y + patch_hw[0], x : x + patch_hw[1]] = True
    return int(mask.sum())


def held_bitwise(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Checks that the kernel's result equals the plain version's bit for
    bit; returns the largest absolute difference between them."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, want), f"{what}: kernel != plain version, max abs diff {err}")
    return err


def check_scatter(recorder: CanvasRecorder, gen: torch.Generator) -> dict:
    """K2 against its plain version (the run's first batch, ragged cases) and its times."""
    probs, positions, valid = recorder.calls[0]
    probs = probs.to(DEVICE)
    canvas_obj = recorder.canvas
    hw = tuple(canvas_obj.canvas.shape[:2])
    ph, pw = probs.shape[1:3]
    ok = canvas_ops.in_range_mask(positions, valid, hw, (ph, pw))
    pos = positions
    start = torch.rand(canvas_obj.canvas.shape, generator=gen, device=DEVICE)
    start_n = torch.randint(0, 3, canvas_obj.count.shape, generator=gen, device=DEVICE).float()
    errs = []

    def both(patches, p, v, c0, n0, what):
        got = canvas_ops.scatter_accumulate(c0.clone(), n0.clone(), patches, p, v)
        want = canvas_ops.scatter_accumulate_reference(c0.clone(), n0.clone(), patches, p, v)
        errs.append(held_bitwise(got[0], want[0], f"scatter {what} canvas"))
        errs.append(held_bitwise(got[1], want[1], f"scatter {what} count"))

    both(probs, pos, ok, start, start_n, "main-path batch")
    last = np.array([[hw[0] - ph, hw[1] - pw]], np.int32)
    both(probs[:1].contiguous(), last, [True], start, start_n, "N=1 at the last row and column")
    some = ok.copy()
    some[1::3] = False
    both(probs, pos, some, start, start_n, "invalid entries")
    small = torch.rand((300, 257, 5), generator=gen, device=DEVICE)
    small_n = torch.zeros((300, 257, 1), device=DEVICE)
    rng = np.random.default_rng(12)
    ragged_pos = np.concatenate(
        [rng.integers(0, [300 - 37, 257 - 53], (12, 2)), [[300 - 37, 257 - 53]]]
    ).astype(np.int32)
    ragged_ok = rng.random(13) > 0.2
    ragged = torch.rand((13, 37, 53, 5), generator=gen, device=DEVICE)
    both(ragged, ragged_pos, ragged_ok, small, small_n, "N=13 patches 37x53, some invalid")

    c, n = start.clone(), start_n.clone()
    kernel_ms = time_ms(lambda: canvas_ops.scatter_accumulate(c, n, probs, pos, ok), 20)
    plain_ms = time_ms(lambda: canvas_ops.scatter_accumulate_reference(c, n, probs, pos, ok), 5)
    # yardstick: index_put_(accumulate=True) with precomputed flat indices,
    # one call for the canvas and one for the count
    sel = torch.from_numpy(np.flatnonzero(ok)).to(DEVICE)
    ys = torch.from_numpy(pos[ok, 0]).to(DEVICE).long()[:, None, None] + torch.arange(ph, device=DEVICE)[None, :, None]
    xs = torch.from_numpy(pos[ok, 1]).to(DEVICE).long()[:, None, None] + torch.arange(pw, device=DEVICE)[None, None, :]
    pix = ys * hw[1] + xs
    idx_c = (pix[..., None] * 5 + torch.arange(5, device=DEVICE)).reshape(-1)
    idx_n = pix.reshape(-1)
    vals = probs[sel].reshape(-1)
    ones = torch.ones_like(idx_n, dtype=torch.float32)
    flat_c, flat_n = c.view(-1), n.view(-1)
    library_ms = time_ms(
        lambda: (
            flat_c.index_put_((idx_c,), vals, accumulate=True),
            flat_n.index_put_((idx_n,), ones, accumulate=True),
        ),
        5,
    )
    n_valid = int(ok.sum())
    area = _covered_area(hw, pos, ok, (ph, pw))
    n_bytes = n_valid * ph * pw * 5 * 4 + area * 6 * 4 * 2 + len(pos) * 16
    return {
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": _bound(n_bytes),
        "bytes": n_bytes,
        "covered_pixels": area,
        "patches": n_valid,
    }


def check_normalize(canvas_obj, h: int, w: int) -> dict:
    """K3 against its plain version (float32 and float16, ragged rows) and its times."""
    cv, cn = canvas_obj.canvas, canvas_obj.count
    errs = [
        held_bitwise(
            canvas_ops.normalize_rows(cv, cn, y0, bh, width, dtype),
            canvas_ops.normalize_rows_reference(cv, cn, y0, bh, width, dtype),
            f"normalize {dtype} rows {y0}+{bh} width {width}",
        )
        for dtype in (torch.float32, torch.float16)
        for y0, bh, width in ((0, h, w), (7, min(333, h - 7), min(4001, w - 1)), (h - 1, 1, 1))
    ]
    times = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: canvas_ops.normalize_rows(cv, cn, 0, h, w), 20),
        "f16_ms": time_ms(lambda: canvas_ops.normalize_rows(cv, cn, 0, h, w, torch.float16), 20),
        "plain_ms": time_ms(lambda: canvas_ops.normalize_rows_reference(cv, cn, 0, h, w), 10),
        # yardstick: the division as PyTorch expressions (clamp, broadcast divide)
        "library_ms": time_ms(lambda: torch.div(cv[:h, :w], cn[:h, :w].clamp_min(1.0)), 10),
    }
    n_bytes = h * w * (5 + 1) * 4 + h * w * 5 * 4
    times["bound_ms"] = _bound(n_bytes)
    times["f16_bound_ms"] = _bound(h * w * (5 + 1) * 4 + h * w * 5 * 2)
    times["bytes"] = n_bytes
    return times


def check_extract(slide: Path, dataset, plan) -> dict:
    """K4 against its plain version (a real band and batch, ragged cases) and its times."""
    band = plan.bands[0]
    img = WSIReader.open(slide).read_rect(
        location=(band.read_x, band.read_y),
        size=(band.band_w, band.band_h),
        resolution=dataset.resolution,
        units=dataset.units,
        coord_space="resolution",
    )
    dev = torch.from_numpy(np.ascontiguousarray(img)).to(DEVICE)
    ph, pw = plan.patch_h, plan.patch_w
    starts = band.starts_local[:SEG_BATCH]
    cases = {
        "main-path batch": (starts, (ph, pw)),
        "N=1 at the last row and column": ([[band.band_h - ph, band.band_w - pw]], (ph, pw)),
        "5 patches 7x15 (rows not 16-byte words), one past the edge": (
            [[0, 0], [3, 11], [band.band_h - 7, band.band_w - 15], [100, 2001], [band.band_h, -4]],
            (7, 15),
        ),
    }
    errs = [
        held_bitwise(
            region_ops.extract_patches(dev, st, hw),
            region_ops.extract_patches_reference(dev, st, hw),
            f"extract {what}",
        )
        for what, (st, hw) in cases.items()
    ]
    st_dev = torch.from_numpy(np.asarray(starts)).to(DEVICE).long()
    iy = st_dev[:, 0, None, None] + torch.arange(ph, device=DEVICE)[None, :, None]
    ix = st_dev[:, 1, None, None] + torch.arange(pw, device=DEVICE)[None, None, :]
    # each band pixel that a patch covers is read once, each output byte written once
    area = _covered_area(tuple(dev.shape[:2]), np.asarray(starts), np.ones(len(starts), bool), (ph, pw))
    n_bytes = area * 3 + len(starts) * ph * pw * 3 + len(starts) * 8
    return {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: region_ops.extract_patches(dev, starts, (ph, pw)), 20),
        "plain_ms": time_ms(lambda: region_ops.extract_patches_reference(dev, starts, (ph, pw)), 10),
        # yardstick: advanced indexing with precomputed row and column indices
        "library_ms": time_ms(lambda: dev[iy, ix], 10),
        "bound_ms": _bound(n_bytes),
        "bytes": n_bytes,
        "covered_band_pixels": area,
        "band_shape": list(dev.shape),
    }


def kernel_row(name, source, replaces, launches, measured) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": measured["max_abs_err"],
        "ms": measured["ms"],
        "plain_ms": measured["plain_ms"],
        "bound_ms": measured["bound_ms"],
        "bound_by": "bytes",
        "library_ms": measured["library_ms"],
    }


def phase_segment(tmp: Path, card: str) -> list[dict]:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    slide = phase_segment_slide(tmp)
    t0 = time.perf_counter()
    model, ioconfig = get_pretrained_model(SEG_MODEL, device=DEVICE)
    check(isinstance(model, UNetModel) and model.device.type == DEVICE, "segment model on the card")
    res = ioconfig.highest_input_resolution
    dataset = WSIPatchDataset(
        slide,
        patch_input_shape=tuple(ioconfig.patch_input_shape),
        stride_shape=tuple(ioconfig.stride_shape),
        resolution=res["resolution"],
        units=res["units"],
        patch_output_shape=tuple(ioconfig.patch_output_shape),
        auto_get_mask=False,
    )
    check(len(dataset) >= 100, f"{len(dataset)} patches")
    first = np.stack([dataset[i]["image"] for i in range(SEG_BATCH)])
    temper_random_weights(model)
    calibrate_batch_norm(model, first)
    # warm-up: cuDNN picks its algorithms
    UNetModel.infer_batch_device(model, torch.from_numpy(first).to(DEVICE))
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t0
    plan = region_ops.BandPlan.build(
        np.asarray(dataset.inputs), dataset.patch_input_shape, dataset.stride_shape
    )
    # batches of either run: at most one partial batch per band
    n_slots = -(-len(dataset) // SEG_BATCH) + len(plan.bands)

    region, region_rec, region_counts = run_segment_path(
        model, slide, ioconfig, card, "device-canvas+region-feed", n_slots, auto_get_mask=False
    )
    check(all(n > 0 for n in region_counts.values()), f"region-feed launches {region_counts}")
    # K2 and K3 against their plain versions on the run's first batch and
    # canvas, which then go, so the next run's peak is its own
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    h, w = SEG_SLIDE_WH[1], SEG_SLIDE_WH[0]
    scatter = check_scatter(region_rec, gen)
    normalize = check_normalize(region_rec.canvas, h, w)
    card_probs = region_rec.calls[0][0].numpy().copy()
    del region_rec
    masked, _, masked_counts = run_segment_path(
        model, slide, ioconfig, card, "device-canvas", n_slots, min_mask_ratio=SEG_MIN_MASK_RATIO
    )
    check(
        masked_counts["scatter_accumulate"] > 0
        and masked_counts["normalize_rows"] > 0
        and masked_counts["extract_patches"] == 0,
        f"per-patch launches {masked_counts}",
    )
    on_card = torch.from_numpy(first).to(DEVICE)
    forward_ms = time_ms(lambda: UNetModel.infer_batch_device(model, on_card), 5)
    region.update(forward_ms_per_batch=forward_ms, setup_seconds=setup_seconds)
    emit(region)
    emit(masked)
    # a kernel's error over its own cases and both runs' re-stitch
    for measured, key in ((scatter, "scatter_max_abs_err"), (normalize, "normalize_max_abs_err")):
        measured["max_abs_err"] = max(
            measured["max_abs_err"], region["restitch"][key], masked["restitch"][key]
        )

    # the first batch of the region-feed run against the same model on the CPU
    kwargs = PRETRAINED_MODELS[SEG_MODEL]["architecture"]["kwargs"]
    cpu_model = UNetModel(**kwargs, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t_cpu = time.perf_counter()
    cpu_probs = UNetModel.infer_batch(cpu_model, first)
    with torch.inference_mode():
        card_logits = model(on_card.float() / 255.0).cpu().double()
        cpu_logits = cpu_model(torch.from_numpy(first).float() / 255.0).double()
    cpu_seconds = time.perf_counter() - t_cpu
    cpu_err = float(np.abs(cpu_probs - card_probs).max())
    logit_err = float((card_logits - cpu_logits).abs().max())
    logit_scale = float(cpu_logits.abs().max())
    logit_spread = float((cpu_logits - cpu_logits.mean(dim=0)).abs().max())
    check(cpu_err <= 1e-3, f"card vs CPU probabilities max abs diff {cpu_err} > 1e-3")
    check(
        logit_err <= 1e-4 * logit_scale,
        f"card vs CPU logits max abs diff {logit_err} > 1e-4 * max |logit| {logit_scale}",
    )
    check(
        logit_err <= 1e-3 * logit_spread,
        f"card vs CPU logits max abs diff {logit_err} > 1e-3 * patch spread {logit_spread}",
    )

    # one bfloat16 batch: weights and activations in bf16, softmax in float32
    model_bf16 = UNetModel(**kwargs, compute_dtype=torch.bfloat16, device=DEVICE)
    model_bf16.load_state_dict(model.state_dict())
    bf16 = UNetModel.infer_batch_device(model_bf16, on_card).cpu().numpy()
    bf16_ms = time_ms(lambda: UNetModel.infer_batch_device(model_bf16, on_card), 5)
    bf16_diff = np.abs(bf16 - card_probs)
    bf16_agree = float((bf16.argmax(-1) == card_probs.argmax(-1)).mean())
    check(bf16.dtype == np.float32 and bf16.shape == card_probs.shape, "bf16 output")
    check(bool(np.isfinite(bf16).all()), "bf16 probabilities finite")
    check(float(np.abs(bf16.sum(-1) - 1).max()) <= 1e-4, "bf16 probabilities sum to 1")
    check(float(bf16_diff.mean()) <= 0.05, f"bf16 vs float32 mean abs diff {bf16_diff.mean()} > 0.05")
    check(bf16_agree >= 0.8, f"bf16 vs float32 argmax agreement {bf16_agree} < 0.8")
    emit(
        {
            "phase": "segment_check",
            "first_batch": list(first.shape),
            "cpu_seconds": cpu_seconds,
            "cpu_max_abs_diff": cpu_err,
            "cpu_logit_max_abs_diff": logit_err,
            "logit_max_abs": logit_scale,
            "logit_patch_spread": logit_spread,
            "bf16_forward_ms_per_batch": bf16_ms,
            "bf16_max_abs_diff": float(bf16_diff.max()),
            "bf16_mean_abs_diff": float(bf16_diff.mean()),
            "bf16_argmax_agreement": bf16_agree,
            "card": card,
        }
    )

    # K4 against its plain version on the card, and its times
    extract = check_extract(slide, dataset, plan)
    launches = {k: region_counts[k] + masked_counts[k] for k in SEG_KERNELS}
    emit(
        {
            "phase": "segment_kernels",
            "launches_region_feed": region_counts,
            "launches_per_patch": masked_counts,
            "scatter_accumulate": {**scatter, "share_of_bound": scatter["bound_ms"] / scatter["ms"]},
            "normalize_rows": {**normalize, "share_of_bound": normalize["bound_ms"] / normalize["ms"]},
            "extract_patches": {**extract, "share_of_bound": extract["bound_ms"] / extract["ms"]},
            "card": card,
        }
    )
    csrc = "tiatoolbox_tpu_torch/csrc/"
    return [
        kernel_row("scatter_accumulate", csrc + "canvas.cu", "tiatoolbox_tpu/ops/canvas.py:53",
                   launches["scatter_accumulate"], scatter),
        kernel_row("normalize_rows", csrc + "canvas.cu", "tiatoolbox_tpu/ops/canvas.py:77",
                   launches["normalize_rows"], normalize),
        kernel_row("extract_patches", csrc + "region.cu", "tiatoolbox_tpu/ops/region.py:42",
                   launches["extract_patches"], extract),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run.", file=sys.stderr)
        return 1
    card = phase_env()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        slide = phase_slide(Path(tmp))
        stain = phase_stain(slide)
        phase_predict(slide, card)
        segment = phase_segment(Path(tmp), card)
    print(json.dumps({"kernels": [stain, *segment]}), flush=True)
    print(card, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
