"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc, writes a synthetic 4096x3072
deflate pyramidal slide at 0.5 mpp to a temporary directory, and drives the
port's two entry points on it:

- A, stain normalisation: get_normalizer("macenko") -> fit(target) ->
  prepare_tile_transform(thumbnail) -> transform_tiles(batch) over every
  224x224 patch batch of the slide (the stain kernel);
- B, whole-slide patch classification: PatchPredictor with a seeded
  resnet18 CNNModel (9 classes, full width and depth, batch-norm statistics
  taken from the slide's first batch of patches) over the slide with the
  kather100k ioconfig and the Otsu tissue mask.

Each phase prints one JSON line. The stain kernel is held against its plain
PyTorch version on the card (on the main path's first batch, on all 2^24 RGB
colours, and on ragged and misaligned inputs) and timed beside it with CUDA
events; the classifier's first batch (probabilities and logits) is held
against the same model on the CPU. The script prints a "kernels" line, the
card's name and power limit, and last the result line
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
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel  # noqa: E402
from tiatoolbox_tpu_torch.models.dataset import WSIPatchDataset  # noqa: E402
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig  # noqa: E402
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor  # noqa: E402
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


def calibrate_batch_norm(model: CNNModel, images: np.ndarray) -> None:
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
    print(json.dumps({"kernels": [stain]}), flush=True)
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
