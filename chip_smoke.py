"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc and its host C++ with g++ (one
process per source, all at once), writes synthetic pyramidal slides to a
temporary directory, and drives the port's entry points on them:

- "jpeg", the host JPEG codec: the card machine's build of the decoder and
  encoder held to the golden set that scripts/make_jpeg_golden.py made with
  OpenCV (pixels and bytes exact), the level-0 tiles of an 8192x6144 JPEG
  slide (Q 90) decoded on 1 thread and on every thread (identical), the
  encode rate, and the encode -> decode PSNR of a synthetic H&E patch held
  to a floor;
- "mask_extract", bench config 2 as bench.py runs it: the morphological
  tissue mask at 8 mpp, then every 224x224 sliding-window patch at 0.5 mpp
  (min_mask_ratio 0.1) of a 4096x3072 JPEG slide, counted against the CPU
  test's count;
- "predict_jpeg", phase B on the 8192x6144 JPEG slide (each batch's tiles
  decoded by one native prefetch), the first batch held against the CPU;
- A, stain normalisation: get_normalizer("macenko") -> fit(target) ->
  prepare_tile_transform(thumbnail) -> transform_tiles(batch) over every
  224x224 patch batch of a 4096x3072 deflate slide at 0.5 mpp (the stain
  kernel); phases A to D read deflate slides, as in earlier runs;
- B, whole-slide patch classification: PatchPredictor with a seeded
  resnet18 CNNModel (9 classes, full width and depth, batch-norm statistics
  taken from the slide's first batch of patches) over the same slide with
  the kather100k ioconfig and the Otsu tissue mask;
- C ("segment"), whole-slide semantic segmentation: SemanticSegmentor with
  get_pretrained_model("fcn_resnet50_unet-bcss") (full width and depth,
  seeded weights, batch-norm statistics from the first batch, batch 16)
  over a 6144x4608 slide at 0.25 mpp, once through the region feed (bands
  read once, patches cut on the card) and once per patch with the Otsu
  mask; both stitch on the card (the canvas kernels);
- D ("instance"), whole-slide nucleus instance segmentation:
  MultiTaskSegmentor with get_pretrained_model("hovernet_fast-pannuke")
  (full width and depth, the functional checkpoint built from code, batch
  32) over a 4096x3072 slide at 0.25 mpp, three times: the region feed
  with the packed foreground/type plane and the watershed energy computed
  on the card, the per-patch feed with the Otsu mask, and tile mode with
  the host Sobel front-end; the watershed and contours run on the host in
  the port's C++. Each run's maps leave the card through the drain
  (parallel/pipeline.py: copies on a copy stream, row-gated views), and
  post-processing starts on them while they land (each run's last row
  must land after post-processing started): run 1's line gives the
  fetch's dispatch seconds, which must be a small share of the seconds
  from its flush to the uint8 plane's last row, the seconds to the
  energy's, and its post-processing repeated on the materialised views
  (identical instances);
- "wire", the yuv420 wire: K8 (csrc/colorconv.cu) held against its plain
  version bit for bit (the batch entry at B's 64x224^2 in float32 and
  bfloat16 and over every (Y, Cb, Cr) triple, the band entry at C's first
  band and a ragged band) and timed warm and with the L2 cache cold beside
  its bound, its rows naming the design; phase B with
  wire_format="yuv420" (one K8 launch a batch, its first patches against
  the CPU run of the same path) and phase C's region feed with
  band_wire="yuv420" (one K8 launch a band, its first batch of patches
  against the CPU's pack, unpack and cut bit for bit), each against its
  RGB run (probabilities, classes, pack and wire seconds and bytes);
- "dp", batch data parallelism: B, C and D under a mesh of two replicas on
  cuda:0 and under the mesh of every card, against one device (B within
  1e-5, C within 1e-4, D's instances identical on the spill phase's
  2048x1536 slide, which this phase writes); wire and dp together must
  take 25 s at most;
- "outputs", the engines' writers: phase B's, C's and D's results saved as
  zarr, an SQLite AnnotationStore (B, D), QuPath JSON (B, D) and an
  OME-TIFF heatmap (C), each read back with the port's readers (zarr arrays bit for
  bit, one box a patch, one polygon an instance, the heatmap's level 0 bit
  for bit), with each writer's seconds and bytes and SQLite's compile
  options (the R*Tree module is required), then one
  run(output_type="annotationstore", save_dir=...) each for C and D (C's
  store written there only, one polygon set of the map's classes);
- "spill", the host canvas with the device canvas refused: phase C's engine
  on its slide and phase D's on bench config 5's 2048x1536 slide, each in
  RAM (memory_threshold 1.0) and spilled to zarr under save_dir/cache
  (0.0): the spilled result equals the RAM run's bit for bit, C's map is
  within 1e-6 of its device-canvas run, the cache is gone after each run,
  and no canvas kernel launches;
- "detect", nucleus detection: NucleusDetector over mapde-conic (full
  width, seeded, 252^2 patches at stride 150) on phase A/B's 4096x3072
  slide at 0.5 mpp, and over sccnn-crchisto (31^2 patches, 13^2 outputs at
  stride 8, about 12k patches) on a 1024x768 slide at 0.25 mpp; both on the
  per-patch device canvas (their own host preproc refuses the region feed).
  The seeded maps are far below the registry thresholds, so a first run's
  stitched map gives threshold_abs (its 99.9th percentile, printed), and
  the timed run detects above it; its canvas is stitched again with the
  plain K2 and K3 (bit for bit), its detections equal those of the plain
  map, and its first patches match the CPU;
- "nucleus_zoo", the rest of the nucleus models on the multitask engine:
  micronet-consep on the spill phase's 2048x1536 slide (0.25 mpp, per-patch
  feed, its output bias set so half the first batch is foreground) and
  hovernetplus-oed on phase A/B's slide (0.5 mpp; the functional HoVer-Net
  checkpoint in its nucleus branches, the layer branch seeded; region feed,
  the generic fetch: K3 then K5 on the normalised canvas), with instance
  and layer counts, the same re-stitch and CPU checks, and K4 and K5 held
  at HoVer-Net+'s shapes;
- "zoo", the patch-classifier zoo: each of the registry's 19 classifier
  backbones as get_pretrained_model("<backbone>-kather100k") and
  ("<backbone>-pcam") at full width (seeded, batch norm calibrated on the
  slide's patches), one batch of 64 at the registry shape (224^2 at 0.5
  mpp, 96^2 at 1.0 mpp) timed and its first patches held against the CPU;
  then PatchPredictor over phase A/B's slide with densenet161-kather100k
  and with resnet18-idars-msi (the float host preproc), counts, grid and
  CPU checked;
- "features", DeepFeatureExtractor over the same slide with
  CNNBackbone("resnet50"), TimmBackbone("UNI") and
  TimmBackbone("efficientnet_b0"), each written to zarr and read back
  equal, on the predictor's grid, its first patches against the CPU; then
  each other VIT_CONFIGS encoder at full width on one batch of 16 (H0-mini
  also against the CPU). No hand-written kernel is on these two phases'
  path: their kernel counts are read and printed (all zero);
- "registry_tail", the registry entries ported last, each at full registry
  width with seeded weights (batch norms calibrated on patches spread over
  the slide, the output convolutions scaled so the first logits lie within
  +-4): KongNet_CoNIC_1 through NucleusDetector.run over phase A/B's slide
  (221 patches of 256^2 at stride 248, batch 16; the threshold from a
  first run's map, the canvas stitched again with the plain K2 and K3, its
  detections those of the plain map, its forward's TFLOP/s), one batch of
  each other KongNet entry (the 512^2 mitosis detector, the wide decoder,
  the 10-head entry; K2 and K3 held on its maps), GrandQC and EfficientUNet
  through SemanticSegmentor.run over a 4096x3072 slide declared at 8 mpp
  (their host preprocs: the per-patch feed; GrandQC's JPEG-80 round trip
  held to tiatoolbox_tpu_torch/data/grandqc_jpeg_golden.npz; each model's
  postproc on the fetched map), unet_tissue_mask_tsef on the region feed
  over phase D's slide (K4, K2 and K3, each canvas pixel covered four
  times), and both NuClick entries on one batch of 128^2 patches with
  seeded clicks; every model's first patches against the CPU;
- "stain_ext", phase A's stain API completed, over phase A's patches and
  batches: get_normalizer("reinhard") and ("vahadane") fitted on a seeded
  512x512 H&E target, then transform_tiles over every batch (Reinhard on
  the host with the port's OpenCV-exact LAB; Vahadane through the stain
  kernel), and augment_tiles with a seeded torch.Generator on every batch
  (the stain augmentation kernel, K7, on its tile-uniform path), held
  against its plain version (the first batch, all 2^24 colours, ragged and
  misaligned inputs) and against its general path on the first batch's
  own pixels (bit for bit, 2 and 3 stains), and timed at 2 and 3 stains;
- "readers", the slide readers on the port's own codecs: the level 0 of
  phase A's slide written as a two-level MIRAX tree and a JPEG-tiled TIFF
  (the same Q 90 tile bytes), a JPEG-baseline DICOM instance, a native
  DICOM instance, an NGFF zarr (zlib) and an fsspec reference JSON over
  phase A's deflate TIFF; each reader's full level-0 read equals the TIFF
  holding the same pixels bit for bit (the JPEG TIFF for MIRAX and the JPEG
  DICOM, the deflate TIFF for the rest), then PatchPredictor (resnet18,
  kather100k ioconfig, batch 64) over the MIRAX and the JPEG DICOM slide
  through WSIReader.open gives the predictions of the JPEG TIFF;
- "jp2", JPEG 2000 on the port's own host C++ codec: the card machine's
  build held to tiatoolbox_tpu_torch/data/j2k_golden.npz (cv2's pixels bit
  for bit, the 9/7 streams too, and the reduced reads); the JPEG phase's
  level 0, its top-left 4096^2, written losslessly as a tiled JP2 (a JP2
  box with its mpp), an Aperio 33005 tiled TIFF and a .90 DICOM instance,
  each level-0 read equal to the source bit for bit; decode MPix/s on 1
  thread and on every worker; PatchPredictor (resnet18, kather100k
  ioconfig) over the JP2 and the TIFF with one tissue mask: the same
  predictions, probabilities within 1e-6; and one SemanticSegmentor
  region-feed run (phase C's U-Net, seeded and tempered; K4, K2 and K3)
  over a JP2 and a TIFF of the same 2048x4096 pixels at 0.25 mpp, bit for
  bit;
- "sam", Segment Anything: SAM at SamConfig()'s full ViT-B width (seeded
  weights written as a local checkpoint directory, config.json,
  model.safetensors and preprocessor_config.json, and loaded through
  SAM(dir) and the port's own safetensors reader), PromptSegmentor.run on
  two tiles of phase A's slide (a 1024^2 tile at baseline, and a 2400x1600
  area read at the mpp calc_mpp gives, 1500x1000) with two points, one box,
  and a point and a box; the 1500x1000 tile's point-and-box run held
  against the same checkpoint on the CPU (low-resolution logits and IoU scores, the share
  of mask pixels that agree, the stores' annotation counts); the image
  encoder's ms per image and images/s at batch 4, the prompt encoder and
  mask decoder's ms per prompt, post_process_masks' ms and the peak
  memory. No hand-written kernel is on this path (SAM is convolutions,
  matmuls, softmax, layer norms and interpolation: library calls, as in
  the reference's torch); the kernel counts are read and printed (all
  zero);
- "registration", whole-slide registration: phase A/B's slide read at 1.0
  mpp (2048x1536) and cut to a section's outline is the fixed image; the
  moving slide is it rotated 33 degrees and shifted (48, -36) px by the
  port's OpenCV-exact warp, written as a deflate TIFF; prealignment on
  the Otsu masks (the rotation found must lie within one 10 degree step
  of the truth), DFBRegister.register with VGG16 (seeded, full width) on
  the card, its features at 224^2 held against the CPU and the forward
  timed, estimate_bspline_transform at JAX's defaults (42 x 32 controls,
  200 steps) on the card with its first 10 steps held against the CPU,
  then TransformedWSIReader: an identity read equal to the plain read,
  and whole-slide reads through the affine and through the composed
  field (MPix/s), each closer to the fixed image than the moving slide
  (masked MSE). No hand-written kernel is on this path (VGG16 and the
  B-spline step are library calls); the kernel counts are printed (all
  zero);
- "render", results drawn on the host by the port's C++ rasteriser
  (csrc/raster.cpp, cv2's LINE_8 drawing): the golden set
  tiatoolbox_tpu_torch/data/raster_golden.npz (cv2's draws, blurs and
  colour maps) replayed bit for bit; phase D's run store (2,388 instances)
  opened with WSIReader.open(".db") over D's slide at alpha 0.5, a 2048^2
  region and the thumbnail read; D's AnnotationTileGenerator pyramid (5
  levels, 257 tiles of 256^2) dumped to a .zip, a few tiles read back
  through the port's JPEG decoder and held to the encoder's bytes of
  get_tile; C's run store (about 235,000 polygons) rendered at its
  pyramid's coarsest level (decimated) and as 16 baseline tiles;
  overlay_prediction_mask and overlay_probability_map over C's
  thumbnail-scale prediction; a D tile read through AnnotationStoreReader
  without a base equal to get_tile composited onto white; tiles/s, MPix/s,
  polygons/s and each step's seconds;
- "graph", the card then the host: PatchPredictor (seeded resnet18) over
  KatherPatchDataset's 128-patch synthetic stand-in in patch mode, its
  first patches against the CPU; SlideGraphConstructor.build over the
  "features" phase's resnet50 features and positions on phase A/B's slide,
  node colours from _umap_reducer, plot_graph onto the slide's thumbnail,
  and the golden graph (clusters and edge_index of the JAX package) rebuilt
  equal. Neither phase launches a hand-written kernel.

Each phase prints one JSON line. The stain kernel is held against its plain
PyTorch version on the card (main-path batch, all 2^24 RGB colours, ragged
and misaligned inputs); the canvas and band kernels are held against theirs
bit for bit in phases C and D (each phase's shapes, ragged cases, and every
segment and instance run stitched again by the plain versions); the packed
plane and its hv min/max bit for bit and the energy within 2e-6, on the
run's canvas and ragged sizes, through both of its entries (the
normalised view, and the raw canvas with its count, which the region feed
calls instead of the normalise kernel, with the packing kernel's min/max
in place of its own first pass: bit for bit with the energy without it),
and run 1's post-processing is repeated on the plain versions' planes; tile mode keeps 0.84 +- 0.03 of the whole canvas's
instances (the reference's scheme on these maps, 2004 of 2386 in JAX and
the port on the CPU); every kernel is timed beside its
plain version, a library call where one computes the same function, and its
bound (the normalise kernel also beside a device copy of its bytes). The
classifier's first batch, the U-Net's and HoVer-Net's first patches (2 and
4), and each nucleus model's first patches, are held against the same model
on the CPU, and one bfloat16 batch of each
segmentation model against float32. The script prints a "kernels" line
(K2 to K5 also at each nucleus model's, KongNet's, the tissue masks' and
the tsef U-Net's shapes, named ``kernel[model]``),
the card's name and power limit, and last the result line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero; it also exits non-zero, printing no result, where CUDA is not
available.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tiatoolbox_tpu_torch import PRETRAINED_MODELS, _build, native, rcParam  # noqa: E402
from tiatoolbox_tpu_torch.cli import main as cli_main  # noqa: E402
from tiatoolbox_tpu_torch.utils import yaml_lite  # noqa: E402
from tiatoolbox_tpu_torch.utils.misc import imread, imwrite  # noqa: E402
from tiatoolbox_tpu_torch.visualization.tileserver import TileServer, region_ioconfig  # noqa: E402
from tiatoolbox_tpu_torch.data.synth import (  # noqa: E402
    make_synthetic_dicom,
    make_synthetic_slide,
    synthetic_he_patch,
    write_synthetic_mrxs,
)
from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.hovernet import HoVerNet  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import (  # noqa: E402
    functional_hovernet_state_dict,
)
from tiatoolbox_tpu_torch.models.architecture.grandqc import GrandQCModel, jpeg_roundtrip  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.hovernetplus import HoVerNetPlus  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.kongnet import KongNet  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.nuclick import NuClick  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.sam import SAM, save_sam_checkpoint, seeded_sam_state  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.sam_config import SamConfig  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.sam_processor import post_process_masks, preprocess  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone, CNNModel  # noqa: E402
from tiatoolbox_tpu_torch.models.architecture.vit import VIT_CONFIGS, TimmBackbone  # noqa: E402
from tiatoolbox_tpu_torch.models.dataset import WSIPatchDataset  # noqa: E402
from tiatoolbox_tpu_torch.models.engine import (  # noqa: E402
    DeepFeatureExtractor,
    MultiTaskSegmentor,
    NucleusDetector,
    SemanticSegmentor,
)
from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig  # noqa: E402
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor  # noqa: E402
from tiatoolbox_tpu_torch.models.engine.prompt_segmentor import PromptSegmentor  # noqa: E402
from tiatoolbox_tpu_torch.models.models_abc import ModelABC  # noqa: E402
from tiatoolbox_tpu_torch.ops import canvas as canvas_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import colorconv  # noqa: E402
from tiatoolbox_tpu_torch.ops import hv_energy as energy_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops import region as region_ops  # noqa: E402
from tiatoolbox_tpu_torch.ops.stain import (  # noqa: E402
    augment_path,
    stain_augment,
    stain_augment_reference,
    stain_transform,
    stain_transform_reference,
)
from tiatoolbox_tpu_torch.parallel import BatchLoader, mesh  # noqa: E402
from tiatoolbox_tpu_torch.parallel.pipeline import LazyRowsView  # noqa: E402
from tiatoolbox_tpu_torch.tools.patchextraction import get_patch_extractor  # noqa: E402
from tiatoolbox_tpu_torch.tools.registration.wsi_registration import (  # noqa: E402
    DFBRegister,
    DFBRFeatureExtractor,
    apply_affine_transformation,
    estimate_bspline_transform,
    prealignment,
)
from tiatoolbox_tpu_torch.tools.stainaugment import augment_tiles  # noqa: E402
from tiatoolbox_tpu_torch.tools.stainnorm import get_normalizer  # noqa: E402
from tiatoolbox_tpu_torch.tools.tissuemask import OtsuTissueMasker  # noqa: E402
from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore  # noqa: E402
from tiatoolbox_tpu_torch.data.render_golden import check_graph_golden, check_raster_golden  # noqa: E402
from tiatoolbox_tpu_torch.models.dataset.info import KatherPatchDataset  # noqa: E402
from tiatoolbox_tpu_torch.tools.graph import SlideGraphConstructor  # noqa: E402
from tiatoolbox_tpu_torch.tools.pyramid import AnnotationTileGenerator  # noqa: E402
from tiatoolbox_tpu_torch.utils.imagecodec import imdecode  # noqa: E402
from tiatoolbox_tpu_torch.utils.transforms import background_composite  # noqa: E402
from tiatoolbox_tpu_torch.utils.visualization import (  # noqa: E402
    AnnotationRenderer,
    overlay_prediction_mask,
    overlay_probability_map,
    plot_graph,
)
from tiatoolbox_tpu_torch.models.engine.engine_abc import OUTPUT_SUFFIXES  # noqa: E402
from tiatoolbox_tpu_torch.utils.tiff_to_fsspec import tiff_to_fsspec  # noqa: E402
from tiatoolbox_tpu_torch.utils.misc import rgb2gray_u8  # noqa: E402
from tiatoolbox_tpu_torch.utils.transforms import imresize, shrink_linear_exact  # noqa: E402
from tiatoolbox_tpu_torch.utils.warp import resize_linear, warp_affine  # noqa: E402
from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup, open_zarr  # noqa: E402
from tiatoolbox_tpu_torch.wsicore import tiffio  # noqa: E402
from tiatoolbox_tpu_torch.wsicore.jp2 import encode_tiled_j2k, jp2_container  # noqa: E402
from tiatoolbox_tpu_torch.wsicore.store_reader import (  # noqa: E402
    AnnotationStoreReader,
    FsspecJsonWSIReader,
    TransformedWSIReader,
)
from tiatoolbox_tpu_torch.wsicore.wsireader import (  # noqa: E402
    DICOMWSIReader,
    JP2WSIReader,
    MIRAXWSIReader,
    NGFFWSIReader,
    TIFFWSIReader,
    WSIReader,
)

BATCH = 64
PATCH = 224
SLIDE_WH = (4096, 3072)
# bench config 2 on the port's 4096x3072 JPEG slide (seed 11, Q 90):
# tests/test_torch_patchextraction.py counts the same on the CPU
MASK_EXTRACT_PATCHES = 266
# phase B on JPEG: 0.5 mpp, 20x, 37 x 28 = 1,036 grid patches of 224^2
JPEG_SLIDE_WH = (8192, 6144)
JPEG_QUALITY = 90
# encode -> decode PSNR of the synthetic H&E at Q 90; tests/test_torch_jpeg.py
# holds the CPU build 1 dB above this floor
JPEG_PSNR_FLOOR_DB = 38.0
JPEG_GOLDEN = ROOT / "tiatoolbox_tpu_torch" / "data" / "jpeg_golden.npz"
GRANDQC_GOLDEN = ROOT / "tiatoolbox_tpu_torch" / "data" / "grandqc_jpeg_golden.npz"
# phase B keeps O(batch) on the card: 538,603,008 B at batch 64 on the deflate slide
PREDICT_PEAK_LIMIT = 1 << 30
# Published peaks of one H100 SXM (the port's records use these for bounds).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Per pixel the stain transform reads 3 bytes and writes 3, and does 3 log,
# 3 exp and about 40 other float32 operations.
STAIN_BYTES_PER_PIX = 6
STAIN_OPS_PER_PIX = 46


# what phases B, C and D hand to the "outputs" and "spill" phases: each
# phase's engine, slide, ioconfig and processed result
KEPT: dict[str, dict] = {}


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
            "compile_seconds": dict(_build.compile_seconds),
            "ptxas": {k: _build.ptxas_report(k) for k in libs},
        }
    )


def phase_slide(tmp: Path) -> Path:
    t0 = time.perf_counter()
    path = make_synthetic_slide(
        tmp / "slide.tiff", size=SLIDE_WH, mpp=0.5, objective_power=20, compression="deflate"
    )
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


def check_jpeg_golden() -> dict:
    """The card machine's build of the codec against the golden set that
    scripts/make_jpeg_golden.py made with OpenCV: pixels and bytes exact."""
    g = np.load(JPEG_GOLDEN)
    for i, name in enumerate(g["dec_names"]):
        stream = g["dec_blob"][g["dec_offsets"][i] : g["dec_offsets"][i + 1]].tobytes()
        want = g["dec_pixels"][g["dec_pixel_offsets"][i] : g["dec_pixel_offsets"][i + 1]]
        got = native.decode_jpeg(stream)
        check(np.array_equal(got, want.reshape(g["dec_shapes"][i])), f"golden decode {name}")
    for i, name in enumerate(g["enc_names"]):
        img = g["enc_inputs"][g["enc_input_offsets"][i] : g["enc_input_offsets"][i + 1]]
        img = img.reshape(g["enc_shapes"][i])
        want = g["enc_blob"][g["enc_offsets"][i] : g["enc_offsets"][i + 1]].tobytes()
        got = native.encode_jpeg(img, int(g["enc_quality"][i]))
        check(got == want, f"golden encode {name}: the stream differs from cv2's")
    return {"decode_cases": len(g["dec_names"]), "encode_cases": len(g["enc_names"])}


def check_grandqc_golden() -> dict:
    """GrandQC's JPEG-80 round trip (``grandqc.jpeg_roundtrip``, the port's
    codec) against the golden set that scripts/make_grandqc_golden.py made
    with OpenCV: the stream's bytes and the decoded pixels exact."""
    g = np.load(GRANDQC_GOLDEN)
    n = sum(1 for k in g.files if k.startswith("input_"))
    for i in range(n):
        image = g[f"input_{i}"]
        stream = native.encode_jpeg(np.ascontiguousarray(image[..., ::-1]), int(g["quality"]))
        check(stream == g[f"stream_{i}"].tobytes(), f"GrandQC golden {i}: the stream differs from cv2's")
        check(np.array_equal(jpeg_roundtrip(image), g[f"output_{i}"]), f"GrandQC golden {i}: pixels differ")
    return {"cases": n}


def phase_jpeg(tmp: Path, card: str) -> Path:
    """The host codec: the golden set, level-0 decode of the 8192x6144 JPEG
    slide on 1 and on every thread (identical), encode rate, PSNR floor."""
    golden = check_jpeg_golden()
    t0 = time.perf_counter()
    slide = make_synthetic_slide(
        tmp / "jpeg_slide.tiff",
        size=JPEG_SLIDE_WH,
        mpp=0.5,
        objective_power=20,
        jpeg_quality=JPEG_QUALITY,
    )
    slide_seconds = time.perf_counter() - t0
    tiff = tiffio.TiffFile(slide)
    page = tiff.pages[tiff.pyramid_pages()[0]]
    streams = [
        tiffio._merge_jpeg_tables(page.jpeg_tables or b"", tiff._read(off, n))
        for off, n in zip(page.offsets, page.byte_counts)
    ]
    tl, tw = page.tile_length, page.tile_width
    mpix = len(streams) * tl * tw / 1e6
    n_threads = os.cpu_count() or 1
    native.decode_jpeg_batch(streams[:16], tl, tw, n_threads=1)  # warm: pages, library
    t0 = time.perf_counter()
    one = native.decode_jpeg_batch(streams, tl, tw, n_threads=1)
    one_s = time.perf_counter() - t0
    many_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        many = native.decode_jpeg_batch(streams, tl, tw, n_threads=n_threads)
        many_s.append(time.perf_counter() - t0)
        check(np.array_equal(one, many), "1-thread and n-thread level-0 decodes differ")
    # the top-left JP2_SIDE^2 of level 0 for the jp2 phase
    side = JP2_SIDE // tw
    KEPT["jp2_pixels"] = np.ascontiguousarray(
        one.reshape(page.tiles_down, page.tiles_across, tl, tw, 3)[:side, :side]
        .transpose(0, 2, 1, 3, 4)
        .reshape(side * tl, side * tw, 3)
    )
    t0 = time.perf_counter()
    sizes = [len(native.encode_jpeg(tile, JPEG_QUALITY)) for tile in one]
    encode_s = time.perf_counter() - t0
    he = synthetic_he_patch((2048, 1536), seed=13)
    back = native.decode_jpeg(native.encode_jpeg(he, JPEG_QUALITY)).astype(np.float64)
    psnr = float(10 * np.log10(255.0**2 / np.mean((back - he) ** 2)))
    check(psnr >= JPEG_PSNR_FLOOR_DB, f"JPEG Q{JPEG_QUALITY} PSNR {psnr:.2f} dB < {JPEG_PSNR_FLOOR_DB}")
    emit(
        {
            "phase": "jpeg",
            "golden": golden,
            "slide_seconds": slide_seconds,
            "slide_bytes": slide.stat().st_size,
            "level0_tiles": len(streams),
            "level0_stream_bytes": sum(len(x) for x in streams),
            "decode_mpix_per_s_1_thread": mpix / one_s,
            "decode_mpix_per_s_n_threads": [mpix / x for x in many_s],
            "n_threads": n_threads,
            "cpu_count": os.cpu_count(),
            "encode_mpix_per_s_1_thread": mpix / encode_s,
            "reencoded_bytes": sum(sizes),
            "psnr_db_q90": psnr,
            "psnr_floor_db": JPEG_PSNR_FLOOR_DB,
            "card": card,
        }
    )
    return slide


def phase_mask_extract(tmp: Path, card: str) -> None:
    """Bench config 2 as bench.py:640-667 runs it: the morphological mask at
    8 mpp, then every 224^2 sliding-window patch at 0.5 mpp (ratio 0.1)."""
    slide = make_synthetic_slide(tmp / "mask_extract.tiff", size=SLIDE_WH, mpp=0.5, objective_power=20)

    def run() -> tuple[int, int]:
        wsi = WSIReader.open(slide)
        mask = wsi.tissue_mask(method="morphological", resolution=8.0, units="mpp")
        extractor = get_patch_extractor(
            "slidingwindow",
            input_img=wsi,
            input_mask=mask,
            patch_size=(PATCH, PATCH),
            stride=(PATCH, PATCH),
            resolution=0.5,
            units="mpp",
            min_mask_ratio=0.1,
        )
        n = px = 0
        for patch in extractor:
            check(patch.shape == (PATCH, PATCH, 3) and patch.dtype == np.uint8, "patch shape")
            n += 1
            px += patch.shape[0] * patch.shape[1]
        return n, px

    run()  # warm: page cache, libraries
    t0 = time.perf_counter()
    n, px = run()
    seconds = time.perf_counter() - t0
    check(n == MASK_EXTRACT_PATCHES, f"config 2 kept {n} patches, the CPU test {MASK_EXTRACT_PATCHES}")
    emit(
        {
            "phase": "mask_extract",
            "seconds": seconds,
            "n_patches": n,
            "patches_per_s": n / seconds,
            "mpix_per_s": px / seconds / 1e6,
            "card": card,
        }
    )


def phase_predict_jpeg(slide: Path, card: str) -> None:
    """Phase B on the 8192x6144 JPEG slide: resnet18, batch 64, the kather100k
    ioconfig and the Otsu mask, each batch's tiles decoded by one prefetch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ioconfig = IOPatchPredictorConfig(
        **PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"]
    )
    grid = dict(patch_input_shape=(PATCH, PATCH), stride_shape=(PATCH, PATCH), resolution=0.5, units="mpp")
    n_grid = len(WSIPatchDataset(slide, auto_get_mask=False, **grid))
    expected = WSIPatchDataset(slide, **grid)
    n_first = min(BATCH, len(expected))
    check(n_first > 0, "the tissue mask keeps no patch")
    first = np.stack([expected[i]["image"] for i in range(n_first)])
    model = CNNModel("resnet18", num_classes=9, seed=0)
    calibrate_batch_norm(model, first)
    CNNModel.infer_batch(model, np.zeros((BATCH, PATCH, PATCH, 3), np.uint8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tiffio.reset_decode_counts()
    t0 = time.perf_counter()
    predictor = PatchPredictor(model=model, batch_size=BATCH, verbose=False)
    output = predictor.run([slide], patch_mode=False, ioconfig=ioconfig)[str(slide)]
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    decoded = dict(tiffio.decode_counts)
    stages = predictor.stages

    probs = output["probabilities"]
    check(len(probs) == len(expected), f"patch count {len(probs)} vs {len(expected)}")
    check(np.array_equal(output["coordinates"], expected.inputs), "patch coordinates")
    check(bool(np.isfinite(probs).all()), "probabilities finite")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(row_err <= 1e-4, f"probability rows sum to 1 within {row_err}")
    check(decoded["batch"] > 0, "no tile was decoded by the batch prefetch")
    check(peak <= PREDICT_PEAK_LIMIT, f"peak device memory {peak} B is not O(batch)")
    cpu_model = CNNModel("resnet18", num_classes=9, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_err = float(np.abs(CNNModel.infer_batch(cpu_model, first) - probs[:n_first]).max())
    check(cpu_err <= 1e-3, f"card vs CPU probabilities max abs diff {cpu_err} > 1e-3")
    slot_wait = stages.get("slot_wait", {}).get("seconds", 0.0)
    emit(
        {
            "phase": "predict_jpeg",
            "seconds": seconds,
            "patches": int(len(probs)),
            "grid_patches": n_grid,
            "patches_per_s": len(probs) / seconds,
            "stages": stages,
            "decode_seconds": stages["decode"]["seconds"] - slot_wait,
            "prefetch_seconds": stages.get("prefetch", {}).get("seconds", 0.0),
            "wire_seconds": stages["wire"]["seconds"],
            "decode_share": (stages["decode"]["seconds"] - slot_wait) / seconds,
            "tiles_decoded_by_prefetch_batches": decoded["batch"],
            "tiles_decoded_one_at_a_time": decoded["single"],
            "peak_memory_bytes": int(peak),
            "row_sum_err": row_err,
            "cpu_max_abs_diff": cpu_err,
            "card": card,
        }
    )


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


def model_ready(images: np.ndarray) -> torch.Tensor:
    """A host batch as the model takes it: uint8 / 255, a float batch as it is."""
    x = torch.from_numpy(images).float()
    return x.div_(255.0) if images.dtype == np.uint8 else x


def calibrate_batch_norm(model: ModelABC, images: np.ndarray) -> None:
    """Set every batch norm's statistics to those of ``images``.

    With torchvision's initialisation every batch norm is the identity, and
    the logits hardly depend on the input. One forward in training mode with
    a cumulative average puts the statistics of real patches in place, so
    the card-vs-CPU comparison below sees input-dependent outputs. uint8
    images are scaled to [0, 1]; float ones (a host preproc's output) are
    taken as model-ready, as ``apply_u8`` takes them.
    """
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for norm in norms:
        norm.reset_running_stats()
        norm.momentum = None
    model.train()
    with torch.no_grad():
        model(model_ready(images).to(model.device))
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

    KEPT["B"] = {"engine": predictor, "slide": slide, "ioconfig": ioconfig, "result": output,
                 "seconds": seconds, "stages": predictor.stages, "first": first}
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
    # kept for the outputs phase off the card, so later phases' peaks are their own
    model.to("cpu")
    KEPT["cli"] = {"model": model, "slide": slide, "result": output}


# -- phase C: whole-slide semantic segmentation ---------------------------------

DEVICE = "cuda"
SEG_MODEL = "fcn_resnet50_unet-bcss"
SEG_SLIDE_WH = (6144, 4608)  # 0.25 mpp, 40x: 154 patches of 1024^2 at stride 450
SEG_BATCH = 16
# the per-patch run keeps the patches whose output cell is at least half tissue
SEG_MIN_MASK_RATIO = 0.5
SEG_CPU_PATCHES = 2  # of the first batch, held against the CPU
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
        tmp / "segment.tiff",
        size=SEG_SLIDE_WH,
        mpp=0.25,
        objective_power=40,
        seed=31,
        compression="deflate",
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


def restitch_canvas(recorder: CanvasRecorder) -> tuple[float, torch.Tensor, torch.Tensor]:
    """Stitch a run's recorded patch outputs again with the plain
    ``scatter_accumulate`` on the card; the canvas and the count must equal
    the kernel's bit for bit. Returns the largest difference and the plain
    canvas and count."""
    device_canvas = recorder.canvas
    plain_c = torch.zeros_like(device_canvas.canvas)
    plain_n = torch.zeros_like(device_canvas.count)
    for probs, positions, valid in recorder.calls:
        probs = probs.to(DEVICE)
        ok = canvas_ops.in_range_mask(positions, valid, plain_c.shape[:2], probs.shape[1:3])
        canvas_ops.scatter_accumulate_reference(plain_c, plain_n, probs, positions, ok)
    err = max(
        held_bitwise(device_canvas.canvas, plain_c, "kernel canvas == plain canvas"),
        held_bitwise(device_canvas.count, plain_n, "kernel count == plain count"),
    )
    return err, plain_c, plain_n


def restitch_with_plain_versions(recorder: CanvasRecorder, fetched: np.ndarray) -> dict:
    """``restitch_canvas``, then the plain ``normalize_rows``: the fetched map
    must equal the plain versions' bit for bit."""
    scatter_err, plain_c, plain_n = restitch_canvas(recorder)
    h, w = fetched.shape[:2]
    plain_map = canvas_ops.normalize_rows_reference(plain_c, plain_n, 0, h, w).cpu()
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
    return line, recorder, counts, result


def _bound(n_bytes: float) -> float:
    """Milliseconds to move ``n_bytes`` at the card's published memory rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def cover(pos: np.ndarray, ok: np.ndarray, patch_hw) -> tuple[int, int]:
    """(pixels covered, pixels of the union box) of the valid patches at ``pos``."""
    pos = np.asarray(pos).reshape(-1, 2)[np.asarray(ok, bool)]
    if len(pos) == 0:
        return 0, 0
    y0, x0 = pos.min(axis=0)
    box = np.zeros(tuple(pos.max(axis=0) + patch_hw - (y0, x0)), bool)
    for y, x in (pos - (y0, x0)).tolist():
        box[y : y + patch_hw[0], x : x + patch_hw[1]] = True
    return int(box.sum()), box.size


def held_bitwise(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Checks that the kernel's result equals the plain version's bit for
    bit; returns the largest absolute difference between them."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
    if torch.equal(got, want):
        return 0.0
    err = float((got.double() - want.double()).abs().max())
    check(False, f"{what}: kernel != plain version, max abs diff {err}")


def sparsest_batch(recorder: CanvasRecorder) -> int:
    """The recorded batch whose patches cover the least of their union box:
    on the per-patch feed, the one the mask leaves most gaps in."""
    hw = recorder.canvas.canvas.shape[:2]
    shares = []
    for probs, positions, valid in recorder.calls:
        patch_hw = tuple(probs.shape[1:3])
        covered, box = cover(positions, canvas_ops.in_range_mask(positions, valid, hw, patch_hw), patch_hw)
        shares.append(covered / max(box, 1))
    return int(np.argmin(shares))


def check_scatter(recorder: CanvasRecorder, gen: torch.Generator, ragged: bool = True, batch: int = 0) -> dict:
    """K2 against its plain version (the run's batch ``batch`` and, with
    ``ragged``, the ragged cases) and its times on that batch."""
    probs, positions, valid = recorder.calls[batch]
    probs = probs.to(DEVICE)
    canvas_obj = recorder.canvas
    hw = tuple(canvas_obj.canvas.shape[:2])
    ph, pw, n_ch = probs.shape[1:4]
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
    if ragged:
        check_scatter_ragged(probs, hw, ok, pos, start, start_n, gen, both)

    c, n = start.clone(), start_n.clone()
    kernel_ms = time_ms(lambda: canvas_ops.scatter_accumulate(c, n, probs, pos, ok), 20)
    kernel_cold_ms = cold_ms(lambda: canvas_ops.scatter_accumulate(c, n, probs, pos, ok))
    plain_ms = time_ms(lambda: canvas_ops.scatter_accumulate_reference(c, n, probs, pos, ok), 5)
    # yardstick: index_put_(accumulate=True) with precomputed flat indices,
    # one call for the canvas and one for the count
    sel = torch.from_numpy(np.flatnonzero(ok)).to(DEVICE)
    ys = torch.from_numpy(pos[ok, 0]).to(DEVICE).long()[:, None, None] + torch.arange(ph, device=DEVICE)[None, :, None]
    xs = torch.from_numpy(pos[ok, 1]).to(DEVICE).long()[:, None, None] + torch.arange(pw, device=DEVICE)[None, None, :]
    pix = ys * hw[1] + xs
    idx_c = (pix[..., None] * n_ch + torch.arange(n_ch, device=DEVICE)).reshape(-1)
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
    area, box = cover(pos, ok, (ph, pw))
    n_bytes = n_valid * ph * pw * n_ch * 4 + area * (n_ch + 1) * 4 * 2 + len(pos) * 16
    return {
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "cold_ms": kernel_cold_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": _bound(n_bytes),
        "bytes": n_bytes,
        "covered_pixels": area,
        "box_pixels": box,
        "patches": n_valid,
        "batch": batch,
    }


def check_scatter_ragged(probs, hw, ok, pos, start, start_n, gen, both) -> None:
    """K2's ragged cases: the last pixel, invalid entries, no valid entry,
    odd patch sizes, and a table longer than one launch takes."""
    ph, pw, n_ch = probs.shape[1:4]
    last = np.array([[hw[0] - ph, hw[1] - pw]], np.int32)
    both(probs[:1].contiguous(), last, [True], start, start_n, "N=1 at the last row and column")
    some = ok.copy()
    some[1::3] = False
    both(probs, pos, some, start, start_n, "invalid entries")
    both(probs, pos, np.zeros_like(ok), start, start_n, "no valid entry")
    small = torch.rand((300, 257, n_ch), generator=gen, device=DEVICE)
    small_n = torch.zeros((300, 257, 1), device=DEVICE)
    rng = np.random.default_rng(12)
    ragged_pos = np.concatenate(
        [rng.integers(0, [300 - 37, 257 - 53], (12, 2)), [[300 - 37, 257 - 53]]]
    ).astype(np.int32)
    ragged_ok = rng.random(13) > 0.2
    ragged = torch.rand((13, 37, 53, n_ch), generator=gen, device=DEVICE)
    both(ragged, ragged_pos, ragged_ok, small, small_n, "N=13 patches 37x53, some invalid")
    n_long = 2 * canvas_ops.SCATTER_ENTRIES + 77
    long_pos = rng.integers(0, [300 - 9, 257 - 11], (n_long, 2)).astype(np.int32)
    tiny = torch.rand((n_long, 9, 11, n_ch), generator=gen, device=DEVICE)
    both(tiny, long_pos, rng.random(n_long) > 0.1, small, small_n, f"N={n_long} 9x11, three launches")


def cold_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn()`` with the 50 MB L2 cache cold: ``time_ms`` of a
    256 MB zero fill then ``fn()``, less that of the fill alone. Back-to-back
    calls on the same buffers find them in L2 when they are smaller than it."""
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    return time_ms(lambda: (scrub.zero_(), fn()), reps) - time_ms(scrub.zero_, reps)


def launch_floor() -> dict:
    """Device time of an empty kernel queued back to back as ``time_ms``
    queues the kernels, with no parameters and with K4's 4 KB of them."""
    return {
        "launch_floor_ms": time_ms(lambda: region_ops.launch_empty(DEVICE), 20),
        "launch_floor_args_ms": time_ms(lambda: region_ops.launch_empty(DEVICE, with_args=True), 20),
    }


def check_normalize(canvas_obj, h: int, w: int) -> dict:
    """K3 against its plain version (float32 and float16, ragged rows) and its times."""
    cv, cn = canvas_obj.canvas, canvas_obj.count
    n_ch = cv.shape[-1]
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
    n_bytes = h * w * (n_ch + 1) * 4 + h * w * n_ch * 4
    f16_bytes = h * w * (n_ch + 1) * 4 + h * w * n_ch * 2
    times["bound_ms"] = _bound(n_bytes)
    times["f16_bound_ms"] = _bound(f16_bytes)
    times["bytes"] = n_bytes
    # ceiling: one device copy that reads half these bytes and writes the other half
    for key, moved in (("copy_ms", n_bytes), ("f16_copy_ms", f16_bytes)):
        src = torch.empty(moved // 2, dtype=torch.uint8, device=DEVICE)
        dst = torch.empty_like(src)
        times[key] = time_ms(lambda: dst.copy_(src), 20)
        del src, dst
    return times


def check_extract(slide: Path, dataset, plan, batch: int) -> dict:
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
    starts = band.starts_local[:batch]
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
    area, _ = cover(starts, np.ones(len(starts), bool), (ph, pw))
    n_bytes = area * 3 + len(starts) * ph * pw * 3 + len(starts) * 8
    return {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: region_ops.extract_patches(dev, starts, (ph, pw)), 20),
        "cold_ms": cold_ms(lambda: region_ops.extract_patches(dev, starts, (ph, pw))),
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
        "bound_by": measured.get("bound_by", "bytes"),
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

    region, region_rec, region_counts, region_result = run_segment_path(
        model, slide, ioconfig, card, "device-canvas+region-feed", n_slots, auto_get_mask=False
    )
    KEPT["C"] = {"model": model, "slide": slide, "ioconfig": ioconfig, "result": region_result,
                 "seconds": region["seconds"], "stages": region["stages"]}
    check(all(n > 0 for n in region_counts.values()), f"region-feed launches {region_counts}")
    # K2 and K3 against their plain versions on the run's first batch and
    # canvas, which then go, so the next run's peak is its own
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    h, w = SEG_SLIDE_WH[1], SEG_SLIDE_WH[0]
    scatter = check_scatter(region_rec, gen)
    normalize = check_normalize(region_rec.canvas, h, w)
    card_probs = region_rec.calls[0][0].numpy().copy()
    del region_rec
    masked, masked_rec, masked_counts, _ = run_segment_path(
        model, slide, ioconfig, card, "device-canvas", n_slots, min_mask_ratio=SEG_MIN_MASK_RATIO
    )
    check(
        masked_counts["scatter_accumulate"] > 0
        and masked_counts["normalize_rows"] > 0
        and masked_counts["extract_patches"] == 0,
        f"per-patch launches {masked_counts}",
    )
    # K2 on the per-patch feed's batch with the most gaps between its patches
    scatter_pp = check_scatter(masked_rec, gen, ragged=False, batch=sparsest_batch(masked_rec))
    del masked_rec
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
    scatter["max_abs_err"] = max(scatter["max_abs_err"], scatter_pp["max_abs_err"])

    # the first patches of the region-feed run against the same model on the CPU
    kwargs = PRETRAINED_MODELS[SEG_MODEL]["architecture"]["kwargs"]
    cpu_model = UNetModel(**kwargs, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t_cpu = time.perf_counter()
    cpu_first = first[:SEG_CPU_PATCHES]
    cpu_probs = UNetModel.infer_batch(cpu_model, cpu_first)
    with torch.inference_mode():
        card_logits = model(on_card[:SEG_CPU_PATCHES].float() / 255.0).cpu().double()
        cpu_logits = cpu_model(torch.from_numpy(cpu_first).float() / 255.0).double()
    cpu_seconds = time.perf_counter() - t_cpu
    cpu_err = float(np.abs(cpu_probs - card_probs[:SEG_CPU_PATCHES]).max())
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
            "cpu_patches": SEG_CPU_PATCHES,
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
    extract = check_extract(slide, dataset, plan, SEG_BATCH)
    launches = {k: region_counts[k] + masked_counts[k] for k in SEG_KERNELS}
    emit(
        {
            "phase": "segment_kernels",
            "launches_region_feed": region_counts,
            "launches_per_patch": masked_counts,
            "scatter_accumulate": {**scatter, "share_of_bound": scatter["bound_ms"] / scatter["ms"]},
            "scatter_accumulate_per_patch": {
                **scatter_pp, "share_of_bound": scatter_pp["bound_ms"] / scatter_pp["ms"]
            },
            "normalize_rows": {**normalize, "share_of_bound": normalize["bound_ms"] / normalize["ms"]},
            "extract_patches": {**extract, "share_of_bound": extract["bound_ms"] / extract["ms"]},
            **launch_floor(),
            "card": card,
        }
    )
    model.to("cpu")  # kept for the outputs and spill phases, off the card
    csrc = "tiatoolbox_tpu_torch/csrc/"
    return [
        kernel_row("scatter_accumulate", csrc + "canvas.cu", "tiatoolbox_tpu/ops/canvas.py:53",
                   launches["scatter_accumulate"], scatter),
        kernel_row("normalize_rows", csrc + "canvas.cu", "tiatoolbox_tpu/ops/canvas.py:77",
                   launches["normalize_rows"], normalize),
        kernel_row("extract_patches", csrc + "region.cu", "tiatoolbox_tpu/ops/region.py:42",
                   launches["extract_patches"], extract),
    ]


# -- phase D: whole-slide nucleus instance segmentation ------------------------

INST_MODEL = "hovernet_fast-pannuke"
INST_SLIDE_WH = (4096, 3072)  # 0.25 mpp, 40x: 25 x 19 output cells of 164^2
INST_BATCH = 32
INST_MIN_MASK_RATIO = 0.5
INST_CPU_PATCHES = 4  # of the first batch, held against the CPU
# tile mode: a limit below the 12.6 Mpix canvas sends post-processing through
# the 4-pass tile scheme (2048^2 tiles, the host Sobel front-end per tile)
INST_TILE_LIMIT = 4096 * 2048
# tile mode keeps this share of the region feed's instances (2004 of 2388 on
# the H100; 2004 of 2386 on the CPU with the maps in closed form, in JAX and
# the port alike), within a few percent
INST_TILE_RATIO = 0.84
INST_TILE_RATIO_TOL = 0.03
ENERGY_TOL = 2e-6  # K5 against its plain version, on [0, 1]
# run 1's fetch dispatch (two launches, two pinned allocations) against the
# seconds from its flush to the uint8 plane's last row (the forward's queued
# tail): 0.0034 against 0.5805 s when nothing waits, 0.6056 against 0.5758
# when a first module load did (H100 80GB HBM3, 700 W)
DISPATCH_SHARE = 0.25
# Per pixel K5 must read the hv pair (8 B) and write the energy (4 B, 2 B as
# float16); it does 2 x (21 + 21) multiply-adds for the two separable Sobels
# and about 10 more operations (normalisations, the max).
ENERGY_BYTES_IN = 8
ENERGY_OPS_PER_PIX = 2 * 2 * (21 + 21) + 10
# K6 with the hv min/max reads the whole 4-channel pixel and the count (20 B)
# and writes 1 B; about 20 operations (the count's reciprocal, four divisions
# of 3, the compare, rint, clamp, shift and four min/max). The plane alone
# would need np, tp and the count (13 B): its bound before the fusion, kept
# beside the new one.
PACK_BYTES_PER_PIX = 21
PACK_PLANE_BYTES_PER_PIX = 13
PACK_OPS_PER_PIX = 20
INST_KERNELS = {
    "scatter_accumulate": canvas_ops.scatter_accumulate,
    "normalize_rows": canvas_ops.normalize_rows,
    "extract_patches": region_ops.extract_patches,
    "pack_fg_tp": canvas_ops.pack_fg_tp,
    "hv_energy": energy_ops.hv_energy,
}


def instance_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in INST_KERNELS.items()}


class PostprocCatcher:
    """Keeps the maps and results of every ``postproc`` call of a model. The
    wrapper is an instance attribute, so ``postproc_func`` stays the model's
    own and the engine keeps its full-canvas path."""

    def __init__(self, model: HoVerNet) -> None:
        self.model = model
        self.calls: list = []

    def __enter__(self) -> "PostprocCatcher":
        inner = self.model.postproc

        def catching(raw_maps, offset=(0, 0)):
            out = inner(raw_maps, offset)
            self.calls.append((raw_maps, out))
            return out

        self.model.postproc = catching
        return self

    def __exit__(self, *exc) -> None:
        del self.model.postproc


def run_instance_path(
    model, slide: Path, ioconfig, card: str, want_path: str, n_slots: int, *, tile_limit=None, **run_kwargs
):
    """One whole-slide ``MultiTaskSegmentor.run``, counted from zero. Its
    canvas is stitched again with the plain K2 and compared bit for bit."""
    segmentor = MultiTaskSegmentor(model, batch_size=INST_BATCH, verbose=False)
    if tile_limit is not None:
        segmentor.full_postproc_limit = tile_limit
    recorder = CanvasRecorder(n_slots, (INST_BATCH, *ioconfig.patch_output_shape, 4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in INST_KERNELS.values():
        fn.launches = 0
    with recorder, PostprocCatcher(model) as post:
        t0 = time.perf_counter()
        output = segmentor.run([slide], patch_mode=False, ioconfig=ioconfig, **run_kwargs)
        seconds = time.perf_counter() - t0
    counts = instance_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    summary = segmentor.last_stage_summary
    check(summary["path"] == want_path, f"instance path {summary['path']} != {want_path}")
    instances = output[str(slide)]["instances"]
    check(len(instances) > 0, f"{want_path}: no instances")
    cents = np.array([np.asarray(v["centroid"], float) for v in instances.values()])
    w, h = INST_SLIDE_WH
    check(bool(np.isfinite(cents).all()) and cents.min() >= 0 and cents[:, 0].max() < w
          and cents[:, 1].max() < h, "centroids inside the slide")
    check(all(len(v["contours"]) >= 3 for v in instances.values()), "contours of 3 points or more")
    types = np.array([v["type"] for v in instances.values()])
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    restitch_err = restitch_canvas(recorder)[0]
    line = {
        "phase": "instance",
        "path": summary["path"],
        "seconds": seconds,
        "patches": n_patches,
        "patches_per_s": n_patches / seconds,
        "slide_mpix_per_s": w * h / 1e6 / seconds,
        "instances": len(instances),
        "instances_per_s": len(instances) / seconds,
        "type_counts": np.bincount(types.astype(int), minlength=6).tolist(),
        "peak_memory_bytes": int(peak),
        "launches": counts,
        "wire_pixels": summary.get("wire_pixels"),
        "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
        "restitch_scatter_max_abs_err": restitch_err,
        "card": card,
    }
    return line, recorder, post.calls, instances, counts


def energy_library(hv_view: torch.Tensor):
    """K5's function as PyTorch expressions (reflect pad, two cuDNN
    convolutions a Sobel, ``amin``/``amax``), the yardstick it is timed against."""
    deriv, smooth = energy_ops.sobel_kernels(21)
    kd = torch.from_numpy(deriv).to(DEVICE)
    ks = torch.from_numpy(smooth).to(DEVICE)

    def norm(x):
        return (x - x.amin()) / (x.amax() - x.amin()).clamp_min(1e-30)

    def sep(x, kx, ky):
        x = F.pad(x[None, None], (10, 10, 10, 10), mode="reflect")
        return F.conv2d(F.conv2d(x, kx.view(1, 1, 1, -1)), ky.view(1, 1, -1, 1))[0, 0]

    def library() -> torch.Tensor:
        sh = norm(sep(norm(hv_view[..., 0]), kd, ks))
        sv = norm(sep(norm(hv_view[..., 1]), ks, kd))
        return torch.maximum(1 - sh, 1 - sv)

    return library


def check_energy(hv_view: torch.Tensor, canvas_obj, gen: torch.Generator) -> dict:
    """K5 against its plain version (the run's canvas, ragged maps) and its times,
    through both entries: the normalised ``[H, W, 2]`` view, and the raw
    canvas with its count, whose plain version is plain K3 followed by plain
    K5; and the raw entry with K6's hv min/max (the banded fetch's call)
    against the raw entry without it, bit for bit."""
    h, w = hv_view.shape[:2]
    plain = energy_ops.hv_energy_reference(hv_view)
    errs = [float((energy_ops.hv_energy(hv_view) - plain).abs().max())]
    # float16 out: the kernel's error plus half a float16 step below 1
    f16_err = float((energy_ops.hv_energy(hv_view, dtype=torch.float16).float() - plain).abs().max())
    check(f16_err <= ENERGY_TOL + 2**-12, f"hv_energy float16 vs plain max abs diff {f16_err}")
    cv, cn = canvas_obj.canvas, canvas_obj.count
    raw, raw_count = cv[:h, :w, 1:3], cn[:h, :w]
    raw_plain = energy_ops.hv_energy_reference(canvas_ops.normalize_rows_reference(cv, cn, 0, h, w)[..., 1:3])
    raw_errs = [float((energy_ops.hv_energy(raw, count=raw_count) - raw_plain).abs().max())]
    raw_f16 = energy_ops.hv_energy(raw, dtype=torch.float16, count=raw_count).float()
    raw_f16_err = float((raw_f16 - raw_plain).abs().max())
    check(raw_f16_err <= ENERGY_TOL + 2**-12, f"hv_energy raw-canvas float16 vs plain max abs diff {raw_f16_err}")
    _, minmax = canvas_ops.pack_fg_tp(cv, cn, h, w, 3)
    for dtype in (torch.float32, torch.float16):
        held_bitwise(
            energy_ops.hv_energy(raw, dtype=dtype, count=raw_count, minmax=minmax),
            energy_ops.hv_energy(raw, dtype=dtype, count=raw_count),
            f"hv_energy {dtype} with K6's minmax vs without",
        )
    minmax_err = float((energy_ops.hv_energy(raw, count=raw_count, minmax=minmax) - raw_plain).abs().max())
    del plain, raw_plain, raw_f16
    # raw canvases wider than the crop, with pixels no patch covered
    for (rh, rw), pad, n_ch in (((37, 53), 7, 4), ((333, 4001), 3, 4), ((1, 40), 0, 5), ((2049, 31), 9, 5)):
        rc = torch.randn((rh, rw + pad, n_ch), generator=gen, device=DEVICE)
        rn = torch.randint(0, 3, (rh, rw + pad, 1), generator=gen, device=DEVICE).float()
        if rh == 1:  # one row: dy is zero exactly only where v is constant
            rc[..., 2] = 0.25 * rn[..., 0].clamp_min(1.0)
        want = energy_ops.hv_energy_reference(canvas_ops.normalize_rows_reference(rc, rn, 0, rh, rw)[..., 1:3])
        raw_errs.append(float((energy_ops.hv_energy(rc[:, :rw, 1:3], count=rn[:, :rw]) - want).abs().max()))
    for rh, rw in ((37, 53), (333, 4001), (33, 17), (5, 9), (1, 40), (2049, 31)):
        hv = torch.randn((rh, rw, 2), generator=gen, device=DEVICE)
        if rh == 1:  # one row: dy is zero exactly only where v is constant
            hv[..., 1] = 0.25
        errs.append(float((energy_ops.hv_energy(hv) - energy_ops.hv_energy_reference(hv)).abs().max()))
    torch.cuda.synchronize()
    max_err = max(errs)
    check(max_err <= ENERGY_TOL, f"hv_energy kernel vs plain max abs diff {max_err} > {ENERGY_TOL}")
    raw_err = max(raw_errs)
    check(raw_err <= ENERGY_TOL, f"hv_energy raw-canvas entry vs plain K3 and K5 max abs diff {raw_err} > {ENERGY_TOL}")
    library = energy_library(hv_view)
    lib_err = float((library() - energy_ops.hv_energy_reference(hv_view)).abs().max())
    n_pix = h * w
    bytes_s = (ENERGY_BYTES_IN + 4) * n_pix / HBM_BYTES_PER_S
    ops_s = ENERGY_OPS_PER_PIX * n_pix / FP32_OPS_PER_S
    return {
        "max_abs_err": max(max_err, raw_err),
        "view_max_abs_err": max_err,
        "f16_max_abs_err": f16_err,
        "raw_max_abs_err": raw_err,
        "raw_f16_max_abs_err": raw_f16_err,
        "ms": time_ms(lambda: energy_ops.hv_energy(hv_view), 20),
        "f16_ms": time_ms(lambda: energy_ops.hv_energy(hv_view, dtype=torch.float16), 20),
        "raw_ms": time_ms(lambda: energy_ops.hv_energy(raw, count=raw_count), 20),
        "raw_f16_ms": time_ms(lambda: energy_ops.hv_energy(raw, dtype=torch.float16, count=raw_count), 20),
        "with_minmax_ms": time_ms(lambda: energy_ops.hv_energy(raw, count=raw_count, minmax=minmax), 20),
        "with_minmax_max_abs_err": minmax_err,
        "plain_ms": time_ms(lambda: energy_ops.hv_energy_reference(hv_view), 10),
        "raw_plain_ms": time_ms(lambda: energy_ops.hv_energy_reference(raw, count=raw_count), 10),
        "library_ms": time_ms(library, 10),
        "library_max_abs_diff_from_plain": lib_err,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "shape": [h, w],
    }


def check_pack(canvas_obj, h: int, w: int) -> dict:
    """K6 against its plain version, the plane and the hv min/max bit for bit
    (the run's canvas; crops; no type channel; a 3-channel copy), and its
    times: the main path's call, and L2 cold."""
    cv, cn = canvas_obj.canvas, canvas_obj.count
    three = cv[: h // 2, :, :3].contiguous()
    cases = [(cv, cn, ch, cw, tp) for ch, cw, tp in ((h, w, 3), (h - 7, w - 13, 3), (h, w, -1), (1, 1, 3), (333, 17, 3))]
    cases.append((three, cn[: h // 2], h // 2 - 3, w - 1, -1))
    errs = []
    for c, n, ch, cw, tp in cases:
        what = f"pack {ch}x{cw}x{c.shape[-1]} tp={tp}"
        plane, minmax = canvas_ops.pack_fg_tp(c, n, ch, cw, tp)
        want_plane, want_minmax = canvas_ops.pack_fg_tp_reference(c, n, ch, cw, tp)
        errs.append(held_bitwise(plane, want_plane, what))
        held_bitwise(minmax.view(torch.int32), want_minmax.view(torch.int32), what + " hv min/max bits")
        errs.append(float((minmax - want_minmax).abs().max()))
    del three
    n_pix = h * w
    bytes_s = PACK_BYTES_PER_PIX * n_pix / HBM_BYTES_PER_S
    ops_s = PACK_OPS_PER_PIX * n_pix / FP32_OPS_PER_S

    def fused():
        return canvas_ops.pack_fg_tp(cv, cn, h, w, 3)

    return {
        "max_abs_err": max(errs),
        "ms": time_ms(fused, 20),
        "cold_ms": cold_ms(fused),
        "plain_ms": time_ms(lambda: canvas_ops.pack_fg_tp_reference(cv, cn, h, w, 3), 10),
        "library_ms": None,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "plane_bound_13b_ms": PACK_PLANE_BYTES_PER_PIX * n_pix / HBM_BYTES_PER_S * 1e3,
    }


def repeat_postproc_on_plain_planes(model: HoVerNet, canvas_obj, calls: list, h: int, w: int) -> dict:
    """Run 1's post-processing again on the planes of the plain K6, and of plain
    K3 followed by plain K5 (what the banded fetch's raw-canvas K5 computes);
    reports how far the watershed partition moves with the kernel's energy.
    The run's energy (K5 from K6's hv min/max) also equals K5's raw-canvas
    entry with its own min/max pass, bit for bit."""
    (views, (task,)), = calls
    maps = [np.asarray(m) for m in views]
    cv, cn = canvas_obj.canvas, canvas_obj.count
    packed = canvas_ops.pack_fg_tp_reference(cv, cn, h, w, 3)[0].cpu().numpy()
    check(np.array_equal(packed, maps[0]), "plain packed plane == the run's")
    unfused = energy_ops.hv_energy(cv[:h, :w, 1:3], count=cn[:h, :w])[..., None].cpu().numpy()
    check(np.array_equal(unfused, maps[1]), "the run's energy == K5's raw entry without K6's min/max")
    normalized = canvas_ops.normalize_rows_reference(canvas_obj.canvas, canvas_obj.count, 0, h, w)
    energy = energy_ops.hv_energy_reference(normalized[..., 1:3])[..., None].cpu().numpy()
    energy_diff = float(np.abs(energy - maps[1]).max())
    check(energy_diff <= ENERGY_TOL, f"run energy vs plain energy {energy_diff}")
    (plain_task,) = HoVerNet.postproc(model, [packed, energy])
    got, want = task["predictions"], plain_task["predictions"]
    n_got, n_want = len(task["info_dict"]["box"]), len(plain_task["info_dict"]["box"])
    moved = partition_moved(got, want)
    check(abs(n_got - n_want) <= max(2, 0.005 * n_want), f"instances {n_got} vs plain planes {n_want}")
    check(moved <= 1e-3, f"the watershed partition moved on {moved} of the foreground")
    return {
        "energy_max_abs_diff": energy_diff,
        "instances": n_got,
        "instances_on_plain_planes": n_want,
        "foreground_share_moved": moved,
        "foreground_share": float((packed & 1).mean()),
    }


def postproc_on_materialised_views(model: HoVerNet, calls: list) -> dict:
    """Run 1's post-processing got the drain's ``LazyRowsView``s, still filling;
    ``postproc_func`` again on ``np.asarray`` of the same views must give the
    same instances: the label map bit for bit, the count, every contour."""
    (views, (task,)), = calls
    check(all(isinstance(m, LazyRowsView) for m in views), f"run 1's maps are {[type(m).__name__ for m in views]}")
    (again,) = model.postproc_func([np.asarray(m) for m in views])
    check(np.array_equal(again["predictions"], task["predictions"]), "labels from the materialised views differ")
    got, want = again["info_dict"], task["info_dict"]
    check(len(got["box"]) == len(want["box"]), f"instances {len(got['box'])} vs {len(want['box'])} through the views")
    check(
        all(np.array_equal(a, b) for a, b in zip(got["contours"], want["contours"])),
        "contours from the materialised views differ",
    )
    return {"maps": [type(m).__name__ for m in views], "instances": len(want["box"]), "identical": True}


def drain_stages(line: dict, names: tuple[str, ...]) -> dict:
    """Each drain's stage of a run's summary, with a time: its last row must
    have landed after post-processing started (the engine reads that from
    the two clocks, ``multi_task_segmentor.py::drain_stage``)."""
    out = {}
    for name in names:
        stage = line["stages"].get(name)
        check(
            stage is not None and stage["overlapped_with_postproc"] is True and stage["seconds"] >= 0,
            f"{line['path']}: drain stage {name} is {stage}",
        )
        out[name] = stage
    return out


def partition_moved(got: np.ndarray, want: np.ndarray) -> float:
    """Share of the foreground (of either map) outside the best match of
    each instance of ``got`` to one of ``want``: 0 when the two partitions
    agree, whatever their label numbers."""
    fg = (got > 0) | (want > 0)
    if not fg.any():
        return 0.0
    base = int(want.max()) + 1
    pairs, counts = np.unique(got[fg].astype(np.int64) * base + want[fg], return_counts=True)
    g = pairs // base
    best = np.zeros(int(got.max()) + 1, np.int64)
    np.maximum.at(best, g, counts)
    return 1.0 - float(best[1:].sum()) / float(fg.sum())


def covered_interior(count: torch.Tensor, margin: int) -> torch.Tensor:
    """Pixels at least ``margin`` away from any pixel no patch covered."""
    uncovered = (count[..., 0] == 0).float()[None, None]
    near = F.max_pool2d(uncovered, 2 * margin + 1, stride=1, padding=margin)[0, 0]
    return near == 0


def instances_inside(instances: dict, inside: np.ndarray) -> int:
    cents = np.array([np.asarray(v["centroid"], float) for v in instances.values()])
    xs, ys = np.round(cents[:, 0]).astype(int), np.round(cents[:, 1]).astype(int)
    return int(inside[ys, xs].sum())


def phase_instance(tmp: Path, card: str) -> tuple[list[dict], dict]:
    """Phase D. Returns the K5 and K6 rows of the ``kernels`` line, and for
    K2 to K4 this phase's launches and largest difference from the plain
    versions, which ``main`` adds to phase C's rows."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    slide = make_synthetic_slide(
        tmp / "nuclei.tiff",
        size=INST_SLIDE_WH,
        mpp=0.25,
        objective_power=40,
        seed=41,
        compression="deflate",
    )
    slide_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, ioconfig = get_pretrained_model(INST_MODEL, device=DEVICE)
    model.load_state_dict(functional_hovernet_state_dict(num_types=6, mode="fast"))
    check(isinstance(model, HoVerNet) and model.device.type == DEVICE, "instance model on the card")
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
    first = np.stack([dataset[i]["image"] for i in range(INST_BATCH)])
    on_card = torch.from_numpy(first).to(DEVICE)
    HoVerNet.infer_batch_device(model, on_card)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t0
    forward_ms = time_ms(lambda: HoVerNet.infer_batch_device(model, on_card), 5)
    w, h = INST_SLIDE_WH
    plan = region_ops.BandPlan.build(
        np.asarray(dataset.inputs), dataset.patch_input_shape, dataset.stride_shape
    )
    # batches of any run: at most one partial batch per band
    n_slots = -(-len(dataset) // INST_BATCH) + len(plan.bands)

    # run 1: region feed, post-processing on the whole canvas (K4, K2, K6, and
    # K5 from the raw canvas and count: no K3)
    region, rec1, calls1, inst1, counts1 = run_instance_path(
        model, slide, ioconfig, card, "multitask-device-canvas+region-feed+banded-u8+device-energy",
        n_slots, auto_get_mask=False,
    )
    check(
        counts1["normalize_rows"] == 0 and all(n > 0 for k, n in counts1.items() if k != "normalize_rows"),
        f"region-feed launches {counts1}",
    )
    # the banded fetch: K6 packs the one whole-canvas block, K5 the energy from its min/max
    check(counts1["pack_fg_tp"] == 1 and counts1["hv_energy"] == 1, f"banded fetch launches {counts1}")
    drains = drain_stages(region, ("fetch-banded", "fetch"))
    region["drain"] = {
        "fetch_dispatch_seconds": region["stages"]["fetch-dispatch"]["seconds"],
        "u8_plane_after_flush_seconds": drains["fetch-banded"]["after_flush_seconds"],
        "energy_after_flush_seconds": drains["fetch"]["after_flush_seconds"],
        "fetch_seconds": drains["fetch"]["seconds"],
        "landed_after_postproc_start_seconds": {k: d["landed_after_postproc_start_seconds"] for k, d in drains.items()},
        "overlapped_with_postproc": all(d["overlapped_with_postproc"] for d in drains.values()),
        "instance_postproc_seconds": region["stages"]["instance-postproc"]["seconds"],
        "card": card,
    }
    # Nothing at dispatch may wait for the loop's queued work (a module load,
    # the stream pool): the uint8 plane then lands while the forward's tail
    # still runs, long after the dispatch returned.
    check(
        region["drain"]["fetch_dispatch_seconds"] < DISPATCH_SHARE * region["drain"]["u8_plane_after_flush_seconds"],
        f"the fetch's dispatch waited for the card: {region['drain']}",
    )
    region["views"] = postproc_on_materialised_views(model, calls1)
    KEPT["D"] = {"model": model, "slide": slide, "ioconfig": ioconfig, "instances": inst1}
    region.update(forward_ms_per_batch=forward_ms, setup_seconds=setup_seconds, slide_seconds=slide_seconds)
    region["stages"]["forward_estimate"] = {
        "seconds": forward_ms / 1e3 * -(-len(dataset) // INST_BATCH)
    }
    canvas1 = rec1.canvas
    region["plain_planes"] = repeat_postproc_on_plain_planes(model, canvas1, calls1, h, w)
    # K2 to K4 against their plain versions at this path's shapes: the run's
    # first batch of four-channel patches, its canvas, a band at 256^2
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    scatter = check_scatter(rec1, gen)
    normalize = check_normalize(canvas1, h, w)
    extract = check_extract(slide, dataset, plan, INST_BATCH)
    pack = check_pack(canvas1, h, w)
    normalized = canvas_ops.normalize_rows(canvas1.canvas, canvas1.count, 0, h, w)
    energy = check_energy(normalized[..., 1:3], canvas1, gen)
    del rec1, canvas1, normalized, calls1
    emit(region)

    # run 2: per-patch feed with the Otsu mask ([np, energy, tp]: K2, K3, K5)
    masked, rec2, _, inst2, counts2 = run_instance_path(
        model, slide, ioconfig, card, "multitask-device-canvas+device-energy", n_slots,
        min_mask_ratio=INST_MIN_MASK_RATIO,
    )
    check(
        counts2["scatter_accumulate"] > 0 and counts2["normalize_rows"] > 0 and counts2["hv_energy"] > 0
        and counts2["extract_patches"] == 0 and counts2["pack_fg_tp"] == 0,
        f"per-patch launches {counts2}",
    )
    drain_stages(masked, ("fetch",))
    inside = covered_interior(rec2.canvas.count[:h, :w], margin=48).cpu().numpy()
    n1, n2 = instances_inside(inst1, inside), instances_inside(inst2, inside)
    masked["compared_with_region_feed"] = {
        "interior_share": float(inside.mean()),
        "instances_region_feed": n1,
        "instances_per_patch": n2,
        "relative_difference": abs(n1 - n2) / max(n1, 1),
    }
    # the energy's min and max are taken over each run's whole canvas, and the
    # masked canvas is zero where no patch went: the landscapes differ slightly
    check(abs(n1 - n2) <= 0.02 * n1, f"instances inside the covered region: {n1} vs {n2}")
    # K2 on the per-patch feed's batch with the most gaps between its patches
    scatter_pp = check_scatter(rec2, gen, ragged=False, batch=sparsest_batch(rec2))
    del rec2
    emit(masked)

    # run 3: tile mode (raw maps: K4, K2, K3; the host Sobel front-end per tile)
    tiled, rec3, _, inst3, counts3 = run_instance_path(
        model, slide, ioconfig, card, "multitask-device-canvas+region-feed", n_slots,
        tile_limit=INST_TILE_LIMIT, auto_get_mask=False,
    )
    del rec3
    check(
        counts3["extract_patches"] > 0 and counts3["scatter_accumulate"] > 0 and counts3["normalize_rows"] > 0
        and counts3["hv_energy"] == 0 and counts3["pack_fg_tp"] == 0,
        f"tile-mode launches {counts3}",
    )
    drain_stages(tiled, ("fetch",))
    ratio = len(inst3) / len(inst1)
    tiled["compared_with_region_feed"] = {"instances_region_feed": len(inst1), "ratio": ratio}
    # The reference's tile scheme keeps fewer of this checkpoint's instances
    # than the whole canvas: on these maps, computed in closed form on the
    # CPU, JAX's and the port's tile modes both keep 2004 where the whole
    # canvas gives 2386 (tests/test_torch_tile_mode.py).
    check(
        abs(ratio - INST_TILE_RATIO) <= INST_TILE_RATIO_TOL,
        f"tile mode kept {len(inst3)} of the region feed's {len(inst1)} instances, "
        f"not {INST_TILE_RATIO} +- {INST_TILE_RATIO_TOL} of them",
    )
    emit(tiled)

    # the first patches against the same model on the CPU, and the first batch in bfloat16
    kwargs = PRETRAINED_MODELS[INST_MODEL]["architecture"]["kwargs"]
    cpu_model = HoVerNet(**kwargs, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    t_cpu = time.perf_counter()
    with torch.inference_mode():
        cpu_logits = cpu_model(torch.from_numpy(first[:INST_CPU_PATCHES]).float())
        card_logits = model(on_card[:INST_CPU_PATCHES].float())
    cpu_seconds = time.perf_counter() - t_cpu
    cpu_heads = [x.numpy() for x in HoVerNet._head_outputs(cpu_logits)]
    card_heads = [x.cpu().numpy() for x in HoVerNet._head_outputs(card_logits)]
    compared = {
        "np": (card_heads[0], cpu_heads[0]),
        "hv": (card_heads[1], cpu_heads[1]),
        "tp_softmax": tuple(
            torch.softmax(x["tp"].float(), dim=-1).cpu().numpy() for x in (card_logits, cpu_logits)
        ),
    }
    errs = {}
    for name, (a, b) in compared.items():
        errs[name] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        check(errs[name] <= 1e-4, f"card vs CPU {name}: {errs[name]} of its max magnitude > 1e-4")
    model_bf16 = HoVerNet(**kwargs, compute_dtype=torch.bfloat16, device=DEVICE)
    model_bf16.load_state_dict(model.state_dict())
    bf16_heads = HoVerNet.infer_batch(model_bf16, on_card)
    bf16_ms = time_ms(lambda: HoVerNet.infer_batch_device(model_bf16, on_card), 5)
    f32_heads = HoVerNet.infer_batch(model, on_card)
    fg_agree = float(((bf16_heads[0] >= 0.5) == (f32_heads[0] >= 0.5)).mean())
    check(all(bool(np.isfinite(x).all()) for x in bf16_heads), "bf16 heads finite")
    check(fg_agree >= 0.95, f"bf16 vs float32 foreground agreement {fg_agree} < 0.95")
    emit(
        {
            "phase": "instance_check",
            "first_batch": list(first.shape),
            "cpu_patches": INST_CPU_PATCHES,
            "cpu_seconds": cpu_seconds,
            "cpu_relative_max_abs_diff": errs,
            "cpu_tp_agreement": float((card_heads[2] == cpu_heads[2]).mean()),
            "bf16_forward_ms_per_batch": bf16_ms,
            "bf16_np_max_abs_diff": float(np.abs(bf16_heads[0] - f32_heads[0]).max()),
            "bf16_np_mean_abs_diff": float(np.abs(bf16_heads[0] - f32_heads[0]).mean()),
            "bf16_hv_max_abs_diff": float(np.abs(bf16_heads[1] - f32_heads[1]).max()),
            "bf16_foreground_agreement": fg_agree,
            "card": card,
        }
    )
    # K2's error covers its own cases and the three runs' re-stitch
    scatter["max_abs_err"] = max(
        scatter["max_abs_err"], scatter_pp["max_abs_err"],
        *(run["restitch_scatter_max_abs_err"] for run in (region, masked, tiled)),
    )
    emit(
        {
            "phase": "instance_kernels",
            "launches_region_feed": counts1,
            "launches_per_patch": counts2,
            "launches_tile_mode": counts3,
            **{
                name: {**m, "share_of_bound": m["bound_ms"] / m["ms"]}
                for name, m in (
                    ("scatter_accumulate", scatter), ("scatter_accumulate_per_patch", scatter_pp),
                    ("normalize_rows", normalize), ("extract_patches", extract), ("hv_energy", energy),
                    ("pack_fg_tp", pack),
                )
            },
            "fetch_kernels_ms": pack["ms"] + energy["with_minmax_ms"],
            **launch_floor(),
            "card": card,
        }
    )
    held = {
        name: {"launches": counts1[name] + counts2[name] + counts3[name], "max_abs_err": m["max_abs_err"]}
        for name, m in (("scatter_accumulate", scatter), ("normalize_rows", normalize), ("extract_patches", extract))
    }
    model.to("cpu")  # kept for the outputs and spill phases, off the card
    csrc = "tiatoolbox_tpu_torch/csrc/"
    rows = [
        kernel_row("hv_energy", csrc + "hv_energy.cu", "tiatoolbox_tpu/ops/hv_energy.py:37",
                   counts1["hv_energy"] + counts2["hv_energy"], energy),
        kernel_row("pack_fg_tp", csrc + "canvas.cu",
                   "tiatoolbox_tpu/models/engine/semantic_segmentor.py:461",
                   counts1["pack_fg_tp"], pack),
    ]
    return rows, held


# -- engine outputs and the zarr spill --------------------------------------------

PREDICT_PATCHES = 266  # phase B's patches on its 4096x3072 slide
SPILL_SLIDE_WH = (2048, 1536)  # bench config 5's slide, at 0.25 mpp
SPILL_TOL_DEVICE = 1e-6  # the spilled map against phase C's device canvas


def disk_bytes(path: Path) -> int:
    path = Path(path)
    if path.is_dir():
        return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    return path.stat().st_size


def all_counts() -> dict[str, int]:
    """Launches of every canvas, band, energy and pack kernel since the last reset."""
    return {name: fn.launches for name, fn in INST_KERNELS.items()}


def reset_all_counts() -> None:
    for fn in INST_KERNELS.values():
        fn.launches = 0


def write_each(engine, result: dict, kinds, out_dir: Path, stem: str, scale_factor) -> dict:
    """``engine.save_predictions`` in each output type, as ``run`` names the
    files; seconds and bytes of each writer."""
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    for kind in kinds:
        t0 = time.perf_counter()
        path = engine.save_predictions(
            result, kind, out_dir, output_file=f"{stem}{OUTPUT_SUFFIXES[kind]}", scale_factor=scale_factor
        )
        seconds = time.perf_counter() - t0
        check(Path(path) == out_dir / f"{stem}{OUTPUT_SUFFIXES[kind]}", f"{kind} written to {path}")
        written[kind] = {"path": Path(path), "seconds": seconds, "bytes": disk_bytes(path)}
    return written


def store_rows(path: Path) -> list:
    store = SQLiteStore(path)
    rows = sorted((a.geometry.to_wkb(), json.dumps(a.properties, sort_keys=True)) for a in store.values())
    store.close()
    return rows


def qupath_features(path: Path) -> list:
    return json.loads(Path(path).read_text())["features"]


def timing(written: dict) -> dict:
    return {k: {"seconds": v["seconds"], "bytes": v["bytes"]} for k, v in written.items()}


def phase_outputs(tmp: Path, card: str) -> None:
    """Each phase's result in every output type, read back with the port's
    readers; one ``run(output_type="annotationstore", save_dir=...)`` each for
    C and D through the engine."""
    options = SQLiteStore.compile_options()
    check("ENABLE_RTREE" in options, f"this Python's SQLite lacks the R*Tree module: {options}")
    out = tmp / "outputs"
    line: dict = {"phase": "outputs", "sqlite_compile_options": options}

    # B: 266 patch predictions
    kept = KEPT.pop("B")
    engine, slide, result = kept["engine"], kept["slide"], kept["result"]
    scale = engine._calculate_scale_factor(engine.get_dataloader(slide, ioconfig=kept["ioconfig"], patch_mode=False))
    written = write_each(engine, result, ("zarr", "annotationstore", "qupath"), out / "B", slide.stem, scale)
    group = open_zarr(written["zarr"]["path"])
    for key in ("coordinates", "predictions", "probabilities"):
        check(np.array_equal(np.asarray(group[key]), result[key]), f"B zarr {key} bit for bit")
    n = len(result["predictions"])
    check(n == PREDICT_PATCHES, f"B kept {n} patches, not {PREDICT_PATCHES}")
    check(len(store_rows(written["annotationstore"]["path"])) == n, "B store holds one box a patch")
    check(len(qupath_features(written["qupath"]["path"])) == n, "B QuPath JSON holds one feature a patch")
    line["B"] = {"annotations": n, "scale_factor": list(scale), "writers": timing(written)}

    # C: the region feed's probability map and class map
    kept = KEPT["C"]
    model, slide, ioconfig, result = kept["model"], kept["slide"], kept["ioconfig"], kept["result"]
    seg = SemanticSegmentor(model, batch_size=SEG_BATCH, verbose=False)
    scale = seg._calculate_scale_factor(seg.get_dataloader(slide, ioconfig=ioconfig, patch_mode=False))
    # C's AnnotationStore is written once, by the engine's run below (about
    # 40 s for its 235,000 polygons), not also by save_predictions
    written = write_each(seg, result, ("zarr", "ome-tiff"), out / "C", slide.stem, scale)
    group = open_zarr(written["zarr"]["path"])
    t0 = time.perf_counter()
    for key in ("probabilities", "predictions"):
        check(np.array_equal(np.asarray(group[key]), result[key]), f"C zarr {key} bit for bit")
    zarr_read_seconds = time.perf_counter() - t0
    classes = {int(c) for c in np.unique(result["predictions"]) if c != 0}
    level0 = tiffio.TiffFile(written["ome-tiff"]["path"])
    page = level0.pages[0]
    heat = level0.read_region(0, (0, 0), (page.width, page.height))
    want = np.clip(result["probabilities"][..., 1] * 255.0, 0, 255).astype(np.uint8)
    check(heat.shape == (*want.shape, 3) and all(np.array_equal(heat[..., c], want) for c in range(3)),
          "C OME-TIFF level 0 bit for bit")
    check("<OME" in page.description, "C OME-TIFF carries its OME-XML")
    reset_all_counts()
    t0 = time.perf_counter()
    ran = seg.run([slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False,
                  output_type="annotationstore", save_dir=out / "C_run")[str(slide)]
    run_seconds = time.perf_counter() - t0
    run_counts = all_counts()
    check(Path(ran) == out / "C_run" / f"{slide.stem}.db", f"C run wrote {ran}")
    check(run_counts["scatter_accumulate"] > 0 and run_counts["extract_patches"] > 0, f"C run launches {run_counts}")
    rows = store_rows(ran)
    types = {json.loads(props)["type"] for _, props in rows}
    # a class seen only in specks of under 3 contour points has no polygon
    check(len(rows) > 0 and types <= classes, f"C store classes {types} vs the map's {classes}")
    KEPT["render"] = {"C_store": Path(ran), "C_slide": slide, "C_predictions": result["predictions"],
                      "C_probabilities": result["probabilities"][..., 1]}
    line["C"] = {
        "classes": sorted(classes), "scale_factor": list(scale),
        "writers": timing(written), "zarr_read_seconds": zarr_read_seconds,
        "run_annotationstore": {"seconds": run_seconds, "polygons": len(rows), "launches": run_counts},
    }
    del group, heat, want, rows

    # D: run 1's instances
    kept = KEPT["D"]
    model, slide, ioconfig, instances = kept["model"], kept["slide"], kept["ioconfig"], kept["instances"]
    seg = MultiTaskSegmentor(model, batch_size=INST_BATCH, verbose=False)
    scale = seg._calculate_scale_factor(seg.get_dataloader(slide, ioconfig=ioconfig, patch_mode=False))
    result = {"instances": instances, "canvas_wh": INST_SLIDE_WH}
    written = write_each(seg, result, ("zarr", "annotationstore", "qupath"), out / "D", slide.stem, scale)
    n = len(instances)
    check(len(open_zarr(written["zarr"]["path"]).attrs["instances"]) == n, "D zarr holds every instance")
    check(len(store_rows(written["annotationstore"]["path"])) == n, "D store holds every instance")
    check(len(qupath_features(written["qupath"]["path"])) == n, "D QuPath JSON holds every instance")
    reset_all_counts()
    t0 = time.perf_counter()
    ran = seg.run([slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False,
                  output_type="annotationstore", save_dir=out / "D_run")[str(slide)]
    run_seconds = time.perf_counter() - t0
    run_counts = all_counts()
    check(Path(ran) == out / "D_run" / f"{slide.stem}.db", f"D run wrote {ran}")
    check(run_counts["pack_fg_tp"] > 0 and run_counts["hv_energy"] > 0, f"D run launches {run_counts}")
    ran_n = len(store_rows(ran))
    check(ran_n == n, f"D run's store holds {ran_n} instances, run 1 kept {n}")
    KEPT["render"].update(D_store=Path(ran), D_slide=slide, D_instances=n)
    line["D"] = {
        "instances": n, "scale_factor": list(scale), "writers": timing(written),
        "run_annotationstore": {"seconds": run_seconds, "instances": ran_n, "launches": run_counts},
    }
    line["card"] = card
    emit(line)


class HostCanvasSegmentor(SemanticSegmentor):
    """The semantic engine with the device canvas refused: the host canvas path."""

    def _device_canvas_budget_bytes(self) -> int:
        return 0


class HostCanvasMultiTask(MultiTaskSegmentor):
    """The multitask engine with the device canvas refused: the host canvas path."""

    def _device_canvas_budget_bytes(self) -> int:
        return 0


def spill_pair(engine, slide: Path, ioconfig, save_dir: Path) -> tuple[dict, dict, dict]:
    """The host canvas in RAM (``memory_threshold=1.0``), then spilled to zarr
    under ``save_dir/cache`` (``0.0``); each run's seconds, spilled bytes
    and launches, counted from zero."""
    runs = {}
    for name, threshold, target in (("ram", 1.0, None), ("zarr", 0.0, save_dir)):
        reset_all_counts()
        t0 = time.perf_counter()
        out = engine.run([slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False,
                         memory_threshold=threshold, save_dir=target)[str(slide)]
        runs[name] = {"seconds": time.perf_counter() - t0, "spill_bytes": engine.spill_bytes,
                      "launches": all_counts(), "path": engine.last_stage_summary["path"]}
        runs[name]["output"] = out
    check(runs["ram"]["spill_bytes"] == 0 and runs["zarr"]["spill_bytes"] > 0, "only the zarr run spills")
    check(not (save_dir / "cache").exists(), "the spill's cache is removed")
    for run in runs.values():
        check(all(n == 0 for n in run["launches"].values()), f"the host canvas launches no kernel: {run['launches']}")
    ram, spilled = runs["ram"].pop("output"), runs["zarr"].pop("output")
    return ram, spilled, runs


def instance_rows(instances: dict) -> list:
    return sorted(
        (np.asarray(v["contours"]).tolist(), np.asarray(v["box"]).tolist(), int(v["type"]), float(v["prob"]))
        for v in instances.values()
    )


def phase_spill(tmp: Path, card: str) -> None:
    """Phase C's engine, and phase D's on bench config 5's slide, with the
    device canvas refused: the host canvas in RAM and spilled to zarr."""
    kept = KEPT.pop("C")
    seg = HostCanvasSegmentor(kept["model"], batch_size=SEG_BATCH, verbose=False)
    ram, spilled, runs = spill_pair(seg, kept["slide"], kept["ioconfig"], tmp / "spill_C")
    check(runs["zarr"]["path"] == "host-canvas", f"C spill path {runs['zarr']['path']}")
    for key in ("probabilities", "predictions"):
        check(np.array_equal(spilled[key], ram[key]), f"C spilled {key} == RAM run's, bit for bit")
    device_diff = float(np.abs(spilled["probabilities"] - kept["result"]["probabilities"]).max())
    check(device_diff <= SPILL_TOL_DEVICE, f"C spilled map vs the device canvas: {device_diff} > {SPILL_TOL_DEVICE}")
    line = {"phase": "spill", "C": {**runs, "max_abs_diff_vs_device_canvas": device_diff,
                                    "canvas_bytes": int(ram["probabilities"].nbytes)}}
    del ram, spilled, kept

    kept = KEPT.pop("D")
    slide, slide_seconds = KEPT.pop("spill_D_slide")  # written by the dp phase
    seg = HostCanvasMultiTask(kept["model"], batch_size=INST_BATCH, verbose=False)
    ram, spilled, runs = spill_pair(seg, slide, kept["ioconfig"], tmp / "spill_D")
    check(runs["zarr"]["path"] == "multitask-host-stitch", f"D spill path {runs['zarr']['path']}")
    n = len(ram["instances"])
    check(n > 0 and instance_rows(spilled["instances"]) == instance_rows(ram["instances"]),
          "D spilled instances == RAM run's")
    line["D"] = {**runs, "instances": n, "slide_seconds": slide_seconds}
    line["card"] = card
    emit(line)


# -- the yuv420 wire and batch data parallelism ----------------------------------

WIRE_DP_LIMIT_S = 25.0  # the wire and dp phases together
WIRE_CPU_PATCHES = 8  # of B's first yuv batch, held against the CPU
K8_SOURCE = "tiatoolbox_tpu_torch/csrc/colorconv.cu"
K8_DESIGN = "row-pair strips through shared memory: 16-byte cp.async loads, 4-pixel cells, 16-byte stores"
# per pixel K8 reads 1.5 bytes of planes and writes 3 values
K8_BYTES_PER_PIX = {torch.float32: 13.5, torch.bfloat16: 7.5, torch.uint8: 4.5}


def every_yuv_triple() -> np.ndarray:
    """Planes ``[64, 192, 2048]`` holding every (Y, Cb, Cr) triple: each image's
    chroma is all 65,536 pairs, image k's 2x2 blocks hold luma 4k to 4k + 3."""
    h, w = 128, 2048
    pairs = np.arange(1 << 16)
    planes = np.empty((64, h + h // 2, w), np.uint8)
    offset = (np.arange(h)[:, None] % 2) * 2 + np.arange(w)[None, :] % 2
    for k in range(64):
        planes[k, :h] = 4 * k + offset
    planes[:, h : h + h // 4] = (pairs & 255).astype(np.uint8).reshape(h // 4, w)
    planes[:, h + h // 4 :] = (pairs >> 8).astype(np.uint8).reshape(h // 4, w)
    return planes


def k8_measured(fn, plain, pixels: int, dtype: torch.dtype, max_abs_err: float) -> dict:
    """K8's row numbers: its time warm and with the L2 cache cold, its plain
    version's on the same input, and the byte bound of ``pixels`` pixels out
    in ``dtype``."""
    n_bytes = pixels * K8_BYTES_PER_PIX[dtype]
    return {
        "max_abs_err": max_abs_err,
        "ms": time_ms(fn, 20),
        "cold_ms": cold_ms(fn),
        "plain_ms": time_ms(plain, 5),
        "bound_ms": _bound(n_bytes),
        "bytes": n_bytes,
        "library_ms": None,  # no single PyTorch call unpacks 4:2:0 planes
    }


def band_planes(slide: Path, dataset, plan) -> tuple[np.ndarray, np.ndarray]:
    """The first band of ``plan`` read from ``slide``, and its packed planes."""
    band = plan.bands[0]
    img = WSIReader.open(slide).read_rect(
        location=(band.read_x, band.read_y), size=(band.band_w, band.band_h),
        resolution=dataset.resolution, units=dataset.units, coord_space="resolution",
    )
    return img, colorconv.rgb_image_to_yuv420(img)


def check_k8(b_first: np.ndarray, c_band: np.ndarray, band_hw: tuple[int, int]) -> tuple[dict, dict, dict]:
    """K8 against its plain version on the card, bit for bit: the batch entry
    at B's 64x224^2 (float32 and bfloat16, divided by 255, and float32 over
    every (Y, Cb, Cr) triple), the band entry at C's first band and at a
    ragged band; and each entry's time beside its bound."""
    planes = torch.from_numpy(colorconv.rgb_batch_to_yuv420(b_first)).to(DEVICE)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[str(dtype)] = held_bitwise(
            colorconv.yuv420_to_rgb(planes, dtype, scale=True),
            colorconv.yuv420_batch_to_rgb_reference(planes, dtype, scale=True),
            f"K8 batch {dtype} at B's first batch",
        )
    triples = torch.from_numpy(every_yuv_triple()).to(DEVICE)
    errs["every_triple"] = held_bitwise(
        colorconv.yuv420_to_rgb(triples), colorconv.yuv420_batch_to_rgb_reference(triples),
        "K8 batch over every (Y, Cb, Cr)",
    )
    del triples
    band = torch.from_numpy(c_band).to(DEVICE)
    ragged = torch.from_numpy(colorconv.rgb_image_to_yuv420(synthetic_he_patch((113, 70), seed=3))).to(DEVICE)
    for what, x, hw in (("C's first band", band, band_hw), ("a ragged 70x113 band", ragged, (70, 113))):
        errs[what] = held_bitwise(
            colorconv.yuv420_to_rgb(x, band_hw=hw), colorconv.unpack_yuv420_band_reference(x, hw),
            f"K8 band at {what}",
        )
    n_pix = b_first.shape[0] * b_first.shape[1] * b_first.shape[2]
    batch = k8_measured(
        lambda: colorconv.yuv420_to_rgb(planes, torch.float32, scale=True),
        lambda: colorconv.yuv420_batch_to_rgb_reference(planes, torch.float32, scale=True),
        n_pix, torch.float32, max(errs.values()),
    )
    batch["bf16_ms"] = time_ms(lambda: colorconv.yuv420_to_rgb(planes, torch.bfloat16, scale=True), 20)
    batch["bf16_cold_ms"] = cold_ms(lambda: colorconv.yuv420_to_rgb(planes, torch.bfloat16, scale=True))
    batch["bf16_bound_ms"] = _bound(n_pix * K8_BYTES_PER_PIX[torch.bfloat16])
    band_row = k8_measured(
        lambda: colorconv.yuv420_to_rgb(band, band_hw=band_hw),
        lambda: colorconv.unpack_yuv420_band_reference(band, band_hw),
        band_hw[0] * band_hw[1], torch.uint8, max(errs.values()),
    )
    band_row["band_hw"] = list(band_hw)
    return batch, band_row, errs


def max_abs_diff(a: np.ndarray, b: np.ndarray, rows: int = 256) -> float:
    """``np.abs(a - b).max()`` a block of rows at a time, in one reused
    buffer: a slide-sized map then costs no slide-sized temporary."""
    buf = np.empty((min(rows, len(a)), *a.shape[1:]), np.result_type(a, b))
    most = 0.0
    for i in range(0, len(a), rows):
        out = buf[: min(rows, len(a) - i)]
        np.subtract(a[i : i + rows], b[i : i + rows], out=out)
        most = max(most, float(np.abs(out, out=out).max()))
    return most


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's TF32 convolutions, PyTorch's default, for runs held against
    each other on the card rather than against the CPU."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@contextlib.contextmanager
def step(steps: dict, name: str):
    """Adds the seconds of the ``with`` body to ``steps[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        steps[name] = steps.get(name, 0.0) + time.perf_counter() - t0


def phase_wire(tmp: Path, card: str) -> list[dict]:
    """The yuv420 wire: K8 held and timed, phase B with ``wire_format="yuv420"``
    and phase C's region feed with ``band_wire="yuv420"``, each against its
    RGB run. Returns K8's rows of the ``kernels`` line."""
    t_phase = time.perf_counter()
    line: dict = {"phase": "wire"}
    steps: dict[str, float] = {}
    # B: the predictor's model, slide and RGB result
    kept_b = KEPT["B"]
    model, slide, ioconfig, b_first = kept_b["engine"].model, kept_b["slide"], kept_b["ioconfig"], kept_b["first"]
    # C: the U-Net, its slide and its region-feed result
    kept_c = KEPT["C"]
    seg_model, seg_slide, seg_ioconfig = kept_c["model"], kept_c["slide"], kept_c["ioconfig"]
    res = seg_ioconfig.highest_input_resolution
    with step(steps, "k8_inputs"):
        seg_dataset = WSIPatchDataset(
            seg_slide, patch_input_shape=tuple(seg_ioconfig.patch_input_shape),
            stride_shape=tuple(seg_ioconfig.stride_shape), resolution=res["resolution"], units=res["units"],
            patch_output_shape=tuple(seg_ioconfig.patch_output_shape), auto_get_mask=False,
        )
        plan = region_ops.BandPlan.build(
            np.asarray(seg_dataset.inputs), seg_dataset.patch_input_shape, seg_dataset.stride_shape
        )
        band_rgb, c_band = band_planes(seg_slide, seg_dataset, plan)
    hw = (plan.bands[0].band_h, plan.bands[0].band_w)
    with step(steps, "k8_checks"):
        batch_row, band_row, errs = check_k8(b_first, c_band, hw)
    line["k8_max_abs_err"] = errs

    # B on the yuv420 wire: one K8 launch a batch
    model.to(DEVICE)
    model.wire_format = "yuv420"
    colorconv.yuv420_to_rgb.launches = 0
    t0 = time.perf_counter()
    predictor = PatchPredictor(model=model, batch_size=BATCH, verbose=False)
    out = predictor.run([slide], patch_mode=False, ioconfig=ioconfig)[str(slide)]
    b_seconds = steps["B_yuv_run"] = time.perf_counter() - t0
    b_launches = colorconv.yuv420_to_rgb.launches
    model.wire_format = "rgb"
    rgb = kept_b["result"]
    probs = out["probabilities"]
    n_batches = -(-len(rgb["probabilities"]) // BATCH)
    check(b_launches == n_batches, f"B on the yuv wire launched K8 {b_launches} times, not {n_batches}")
    check(np.array_equal(out["coordinates"], rgb["coordinates"]), "B yuv coordinates")
    check(bool(np.isfinite(probs).all()) and probs.shape == rgb["probabilities"].shape, "B yuv probabilities")
    # its first patches against the CPU run of the same path: pack, plain unpack, forward
    with step(steps, "B_cpu_check"):
        cpu_model = CNNModel("resnet18", num_classes=9, device="cpu")
        cpu_model.load_state_dict(model.state_dict())
        cpu_planes = model.pack_wire(b_first[:WIRE_CPU_PATCHES])
        cpu_probs = CNNModel.infer_batch(cpu_model, cpu_planes)
    cpu_err = float(np.abs(cpu_probs - probs[:WIRE_CPU_PATCHES]).max())
    check(cpu_err <= 1e-3, f"B yuv card vs CPU probabilities max abs diff {cpu_err} > 1e-3")
    model.to("cpu")
    b_stages = predictor.stages
    line["B"] = {
        "seconds": b_seconds, "rgb_seconds": kept_b["seconds"], "patches": len(probs),
        "k8_launches": b_launches, "cpu_max_abs_diff": cpu_err,
        "max_abs_diff_vs_rgb": float(np.abs(probs - rgb["probabilities"]).max()),
        "argmax_agreement_vs_rgb": float((probs.argmax(1) == rgb["predictions"]).mean()),
        "stages": b_stages, "rgb_stages": kept_b["stages"],
    }
    check(b_stages["wire"]["items"] * 2 == b_stages["pack"]["items"], f"B wire bytes {b_stages}")

    # C's region feed on the yuv420 wire: one K8 launch a band
    seg_model.to(DEVICE)
    reset_segment_counts()
    colorconv.yuv420_to_rgb.launches = 0
    t0 = time.perf_counter()
    seg = SemanticSegmentor(seg_model, batch_size=SEG_BATCH, verbose=False)
    result = seg.run([seg_slide], patch_mode=False, ioconfig=seg_ioconfig, auto_get_mask=False,
                     band_wire="yuv420")[str(seg_slide)]
    c_seconds = steps["C_yuv_run"] = time.perf_counter() - t0
    c_launches = colorconv.yuv420_to_rgb.launches
    counts = segment_counts()
    summary = seg.last_stage_summary
    check(summary["path"] == "device-canvas+region-feed" and summary["band_wire"] == "yuv420",
          f"C yuv path {summary['path']}, wire {summary.get('band_wire')}")
    check(c_launches == len(plan.bands) == summary["n_bands"],
          f"C on the yuv wire launched K8 {c_launches} times for {len(plan.bands)} bands")
    check(all(n > 0 for n in counts.values()), f"C yuv launches {counts}")
    rgb_c = kept_c["result"]
    c_probs = result["probabilities"]
    with step(steps, "C_map_checks"):
        check(c_probs.shape == rgb_c["probabilities"].shape and bool(np.isfinite(c_probs).all()), "C yuv map")
        # printed, not held: the seeded U-Net's classes move with a few levels of
        # chroma, as with bf16 (held only to 0.8 agreement in the segment phase);
        # the wire itself is held by K8 and the first batch below
        c_agree = float((result["predictions"] == rgb_c["predictions"]).mean())
        c_diff = max_abs_diff(c_probs, rgb_c["probabilities"])
    # the first batch the model saw, against the CPU: the band packed, unpacked
    # and cut by the plain versions, bit for bit
    starts = plan.bands[0].starts_local[:SEG_BATCH]
    with step(steps, "C_first_batch_check"):
        card_first = region_ops.extract_patches(
            colorconv.unpack_yuv420_band(torch.from_numpy(c_band).to(DEVICE), hw), starts,
            (plan.patch_h, plan.patch_w),
        )
        cpu_first = region_ops.extract_patches_reference(
            colorconv.unpack_yuv420_band_reference(torch.from_numpy(c_band), hw), starts,
            (plan.patch_h, plan.patch_w),
        )
        first_err = held_bitwise(card_first.cpu(), cpu_first, "C's first yuv batch, card against CPU")
        rgb_first = region_ops.extract_patches_reference(
            torch.from_numpy(band_rgb), starts, (plan.patch_h, plan.patch_w)
        )
        first_diff_rgb = int((cpu_first.to(torch.int16) - rgb_first.to(torch.int16)).abs().max())
    seg_model.to("cpu")
    stages = {k: v for k, v in summary.items() if isinstance(v, dict)}
    line["C"] = {
        "seconds": c_seconds, "rgb_seconds": kept_c["seconds"], "k8_launches": c_launches,
        "launches": counts, "n_bands": summary["n_bands"], "first_batch_cpu_max_abs_diff": first_err,
        "first_batch_max_abs_diff_vs_rgb": first_diff_rgb, "max_abs_diff_vs_rgb": c_diff,
        "class_agreement_vs_rgb": c_agree,
        "pack": stages["pack"], "wire": stages["wire"], "rgb_wire": kept_c["stages"]["wire"],
        "stages": stages,
    }
    check(stages["wire"]["items"] <= 0.52 * kept_c["stages"]["wire"]["items"], "C yuv wire bytes about half")
    batch_row["launches"], band_row["launches"] = b_launches, c_launches
    line.update(k8_batch=batch_row, k8_band=band_row, steps=steps, seconds=time.perf_counter() - t_phase, card=card)
    emit(line)
    rows = [
        kernel_row("yuv420_to_rgb", K8_SOURCE, "tiatoolbox_tpu/ops/colorconv.py:118", b_launches, batch_row),
        kernel_row("yuv420_to_rgb[band]", K8_SOURCE, "tiatoolbox_tpu/ops/colorconv.py:107", c_launches, band_row),
    ]
    for row, measured in zip(rows, (batch_row, band_row)):
        row.update(cold_ms=measured["cold_ms"], design=K8_DESIGN)
    return rows


def phase_dp(tmp: Path, card: str) -> float:
    """Batch data parallelism: a mesh of two replicas on ``cuda:0`` and the
    mesh of every local card, each running B, C and D against one device;
    on a one-card host the second mesh runs B only (one replica on the one
    card, C and D's code path already run by the two replicas). Each
    replica takes the single-device run's batch, so cuDNN picks the same
    algorithms. D's runs, held only against each other, use cuDNN's TF32
    (PyTorch's default); B and C are held against TF32-free runs. Writes the
    spill phase's 2048x1536 slide, where D runs. Returns the phase's
    seconds, less the slide's."""
    t_phase = time.perf_counter()
    line: dict = {"phase": "dp"}
    steps: dict[str, float] = {}
    t0 = time.perf_counter()
    d_slide = make_synthetic_slide(tmp / "config5.tiff", size=SPILL_SLIDE_WH, mpp=0.25, objective_power=40)
    slide_seconds = time.perf_counter() - t0
    KEPT["spill_D_slide"] = (d_slide, slide_seconds)
    real_devices = mesh.local_devices
    meshes = {
        "two_replicas_on_cuda0": lambda: [torch.device("cuda", 0)] * 2,
        "every_card": real_devices,
    }
    kept_b, kept_c, kept_d = KEPT["B"], KEPT["C"], KEPT["D"]
    b_model, c_model, d_model = kept_b["engine"].model, kept_c["model"], kept_d["model"]

    def d_run(batch: int) -> tuple[list, float]:
        seg = MultiTaskSegmentor(d_model, batch_size=batch, verbose=False)
        t = time.perf_counter()
        with cudnn_tf32():
            out = seg.run([d_slide], patch_mode=False, ioconfig=kept_d["ioconfig"], auto_get_mask=False)
        return instance_rows(out[str(d_slide)]["instances"]), time.perf_counter() - t

    # D on one device, at the batch each replica takes under two replicas:
    # the instances must be the same
    with step(steps, "moves"):
        d_model.to(DEVICE)
    d_single, d_single_seconds = d_run(INST_BATCH // 2)
    steps["D_single_run"] = d_single_seconds
    check(len(d_single) > 0, "D on one device: no instances")
    line["D_single"] = {"instances": len(d_single), "seconds": d_single_seconds, "batch": INST_BATCH // 2}
    def under_mesh(name: str) -> dict:
        m = mesh.get_data_mesh()
        entry = {"devices": [str(d) for d in m.devices], "size": m.size}
        # B: probabilities within 1e-5 of the single-device run (TF32 off)
        with step(steps, "replicas"):
            b_model.enable_data_parallel()
        t0 = time.perf_counter()
        out = PatchPredictor(model=b_model, batch_size=BATCH, verbose=False).run(
            [kept_b["slide"]], patch_mode=False, ioconfig=kept_b["ioconfig"]
        )[str(kept_b["slide"])]
        b_err = float(np.abs(out["probabilities"] - kept_b["result"]["probabilities"]).max())
        check(b_err <= 1e-5, f"B under {name}: {b_err} > 1e-5")
        entry["B"] = {"max_abs_diff": b_err, "seconds": time.perf_counter() - t0}
        steps[f"B_{name}_run"] = entry["B"]["seconds"]
        if name == "every_card" and m.size == 1:
            return entry
        # C: within 1e-4 of phase C's map, each replica at phase C's batch
        with step(steps, "replicas"):
            c_model.enable_data_parallel()
        t0 = time.perf_counter()
        seg = SemanticSegmentor(c_model, batch_size=SEG_BATCH * m.size, verbose=False)
        out = seg.run([kept_c["slide"]], patch_mode=False, ioconfig=kept_c["ioconfig"],
                      auto_get_mask=False)[str(kept_c["slide"])]
        c_err = max_abs_diff(out["probabilities"], kept_c["result"]["probabilities"])
        check(seg.last_stage_summary["path"] == "device-canvas+region-feed", f"C under {name}")
        check(c_err <= 1e-4, f"C under {name}: {c_err} > 1e-4")
        entry["C"] = {"max_abs_diff": c_err, "seconds": time.perf_counter() - t0}
        steps[f"C_{name}_run"] = entry["C"]["seconds"]
        # D: the same instances, each replica at the single run's batch
        with step(steps, "replicas"):
            d_model.enable_data_parallel()
        d_dp, d_seconds = d_run(INST_BATCH // 2 * m.size)
        steps[f"D_{name}_run"] = d_seconds
        check(d_dp == d_single, f"D under {name}: {len(d_dp)} instances, one device {len(d_single)}")
        entry["D"] = {"instances": len(d_dp), "identical": True, "seconds": d_seconds}
        return entry

    for name, devices in meshes.items():
        mesh.local_devices = devices
        try:
            line[name] = under_mesh(name)
        finally:
            mesh.local_devices = real_devices
            for model in (b_model, c_model, d_model):
                model.mesh = None
        with step(steps, "moves"):
            torch.cuda.empty_cache()
    with step(steps, "moves"):
        for model in (b_model, c_model, d_model):
            model.to("cpu")
    seconds = time.perf_counter() - t_phase - slide_seconds
    line.update(steps=steps, seconds=seconds, slide_seconds=slide_seconds, card=card)
    emit(line)
    return seconds


# -- nucleus detection and the rest of the nucleus zoo --------------------------

DETECT_MODEL = "mapde-conic"  # on phase A/B's 4096x3072 slide at 0.5 mpp
SCCNN_MODEL = "sccnn-crchisto"
SCCNN_SLIDE_WH = (1024, 768)  # 0.25 mpp, 40x: 125 x 93 = 11,625 patches of 31^2 at stride 8
MICRONET_MODEL = "micronet-consep"  # on the spill phase's 2048x1536 slide at 0.25 mpp
PLUS_MODEL = "hovernetplus-oed"  # on phase A/B's slide: 25 x 19 output cells of 164^2
DETECT_BATCH = 16
SCCNN_BATCH = 256
PLUS_BATCH = 32
# The seeded weights give maps far below the registry thresholds (MapDe 205,
# SCCNN 0.2): the detections are taken above this quantile of the stitched map.
DETECT_PEAK_QUANTILE = 0.999
CPU_REL_TOL = 1e-4  # first-batch maps, card against the CPU, of their largest value
ZOO_KERNELS = {
    "scatter_accumulate": ("canvas.cu", "tiatoolbox_tpu/ops/canvas.py:53"),
    "normalize_rows": ("canvas.cu", "tiatoolbox_tpu/ops/canvas.py:77"),
    "extract_patches": ("region.cu", "tiatoolbox_tpu/ops/region.py:42"),
    "hv_energy": ("hv_energy.cu", "tiatoolbox_tpu/ops/hv_energy.py:37"),
}


class CanvasKeepingDetector(NucleusDetector):
    """The detector engine, keeping the stitched map it post-processes."""

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:
        self.kept_canvas = raw_predictions["probabilities"]
        return super().post_process_wsi(raw_predictions, **kwargs)


def first_patches(model, slide: Path, ioconfig, n: int) -> tuple[np.ndarray, WSIPatchDataset]:
    """The first ``n`` grid patches of ``slide`` through the model's own preproc, and the grid."""
    res = ioconfig.highest_input_resolution
    dataset = WSIPatchDataset(
        slide,
        patch_input_shape=tuple(ioconfig.patch_input_shape),
        stride_shape=tuple(ioconfig.stride_shape),
        resolution=res["resolution"],
        units=res["units"],
        patch_output_shape=tuple(ioconfig.patch_output_shape),
        auto_get_mask=False,
        preproc_func=model.preproc_func,
    )
    return np.stack([dataset[i]["image"] for i in range(n)]), dataset


def zoo_run(engine, slide: Path, ioconfig, recorder: CanvasRecorder, want_path: str, **run_kwargs):
    """One whole-slide ``engine.run``, every kernel count set to 0 just before
    and read just after; its output, counts, seconds and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    with recorder:
        t0 = time.perf_counter()
        output = engine.run([slide], patch_mode=False, ioconfig=ioconfig, auto_get_mask=False, **run_kwargs)
        seconds = time.perf_counter() - t0
    counts = all_counts()
    torch.cuda.synchronize()
    summary = engine.last_stage_summary
    check(summary["path"] == want_path, f"{type(engine.model).__name__} path {summary['path']} != {want_path}")
    return output[str(slide)], counts, seconds, int(torch.cuda.max_memory_allocated()), summary


def check_launched(counts: dict, want: tuple, what: str) -> None:
    """Each kernel of ``want`` launched in the run, every other one not."""
    check(all((counts[k] > 0) == (k in want) for k in counts), f"{what} launches {counts}, want {want}")


def held_against_cpu(model, cpu_model, batch: np.ndarray, card_heads) -> float:
    """The card's first-batch maps against the same weights on the CPU: the
    largest difference over each head's largest magnitude."""
    cpu_heads = type(model).infer_batch(cpu_model, batch)
    cpu_heads = cpu_heads if isinstance(cpu_heads, tuple) else (cpu_heads,)
    card_heads = card_heads if isinstance(card_heads, (tuple, list)) else (card_heads,)
    worst = 0.0
    for card, cpu in zip(card_heads, cpu_heads):
        card = card.cpu().numpy() if isinstance(card, torch.Tensor) else card
        worst = max(worst, float(np.abs(card - cpu).max()) / max(float(np.abs(cpu).max()), 1e-30))
    return worst


def detect_path(model_name: str, slide: Path, batch: int, card: str) -> tuple[dict, dict, dict, dict]:
    """NucleusDetector over ``model_name`` on ``slide``: one run with the
    registry threshold, then the timed run with ``threshold_abs`` at
    ``DETECT_PEAK_QUANTILE`` of the first run's stitched map. The timed run's
    canvas is stitched again with the plain K2 and K3 (bit for bit) and its
    detections equal those of the plain map; its first patches match the CPU."""
    model, ioconfig = get_pretrained_model(model_name, device=DEVICE)
    first, dataset = first_patches(model, slide, ioconfig, batch)
    type(model).infer_batch_device(model, first)  # warm-up: cuDNN picks its algorithms
    engine = CanvasKeepingDetector(model, batch_size=batch, verbose=False)
    n_slots = -(-len(dataset) // batch)
    out_hw = tuple(ioconfig.patch_output_shape)
    recorder = CanvasRecorder(n_slots, (batch, *out_hw, 1))
    _, _, calib_seconds, _, _ = zoo_run(engine, slide, ioconfig, recorder, "device-canvas")
    threshold = float(np.quantile(engine.kept_canvas, DETECT_PEAK_QUANTILE))
    found, counts, seconds, peak, summary = zoo_run(
        engine, slide, ioconfig, recorder, "device-canvas", threshold_abs=threshold
    )
    check_launched(counts, ("scatter_accumulate", "normalize_rows"), model_name)
    canvas = engine.kept_canvas
    h, w = canvas.shape[:2]
    check(bool(np.isfinite(canvas).all()) and canvas.shape[2] == 1, f"{model_name} map {canvas.shape}")
    n_found = len(found["coordinates"])
    check(n_found > 0, f"{model_name}: no detections above {threshold}")
    xy = np.asarray(found["coordinates"])
    check(xy[:, 0].max() < w and xy[:, 1].max() < h and xy.min() >= 0, "detections inside the map")
    scatter_err, plain_c, plain_n = restitch_canvas(recorder)
    plain_map = canvas_ops.normalize_rows_reference(plain_c, plain_n, 0, h, w).cpu().numpy()
    del plain_c, plain_n
    map_err = held_bitwise(torch.from_numpy(canvas), torch.from_numpy(plain_map), "kernel-normalised map == plain map")
    plain_found = engine.post_process_wsi({"probabilities": plain_map})
    for key in ("coordinates", "scores", "types"):
        check(np.array_equal(found[key], plain_found[key]), f"{model_name} detections of the plain map: {key}")
    card_first = recorder.calls[0][0][:2]
    cpu_model = type(model)(**PRETRAINED_MODELS[model_name]["architecture"]["kwargs"], device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_err = held_against_cpu(model, cpu_model, first[: len(card_first)], card_first)
    check(cpu_err <= CPU_REL_TOL, f"{model_name} card vs CPU maps: {cpu_err} of their max > {CPU_REL_TOL}")
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    scatter = check_scatter(recorder, gen, ragged=False)
    normalize = check_normalize(recorder.canvas, h, w)
    scatter["max_abs_err"] = max(scatter["max_abs_err"], scatter_err)
    normalize["max_abs_err"] = max(normalize["max_abs_err"], map_err)
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    line = {
        "phase": "detect",
        "model": model_name,
        "path": summary["path"],
        "slide_wh": [w, h],
        "seconds": seconds,
        "first_run_seconds": calib_seconds,
        "patches": n_patches,
        "patches_per_s": n_patches / seconds,
        "threshold_abs": threshold,
        "threshold_quantile": DETECT_PEAK_QUANTILE,
        "detections": n_found,
        "detections_per_s": n_found / seconds,
        "map_max": float(canvas.max()),
        "peak_memory_bytes": peak,
        "launches": counts,
        "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
        "cpu_relative_max_abs_diff": cpu_err,
        "restitch_scatter_max_abs_err": scatter_err,
        "restitch_normalize_max_abs_err": map_err,
        "card": card,
    }
    del recorder
    model.to("cpu")
    return line, counts, scatter, normalize


def phase_detect(slide: Path, tmp: Path, card: str) -> list[dict]:
    """MapDe over phase A/B's slide and SCCNN over a 1024x768 slide at 0.25 mpp."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    t0 = time.perf_counter()
    sccnn_slide = make_synthetic_slide(
        tmp / "sccnn.tiff", size=SCCNN_SLIDE_WH, mpp=0.25, objective_power=40, seed=53, compression="deflate"
    )
    slide_seconds = time.perf_counter() - t0
    for name, path, batch in ((DETECT_MODEL, slide, DETECT_BATCH), (SCCNN_MODEL, sccnn_slide, SCCNN_BATCH)):
        line, counts, scatter, normalize = detect_path(name, path, batch, card)
        if name == SCCNN_MODEL:
            line["slide_seconds"] = slide_seconds
        line["kernels"] = {"scatter_accumulate": scatter, "normalize_rows": normalize}
        emit(line)
        rows += zoo_rows(name, counts, {"scatter_accumulate": scatter, "normalize_rows": normalize})
    return rows


def zoo_rows(model_name: str, counts: dict, measured: dict) -> list[dict]:
    """``kernels`` rows at one model's shapes, named ``kernel[model]``."""
    csrc = "tiatoolbox_tpu_torch/csrc/"
    return [
        kernel_row(f"{name}[{model_name}]", csrc + ZOO_KERNELS[name][0], ZOO_KERNELS[name][1], counts[name], m)
        for name, m in measured.items()
    ]


def temper_micronet(model, batch: np.ndarray) -> float:
    """Set the output head's bias so that the seeded network calls half of
    ``batch``'s pixels foreground (its two logits differ by a hair
    everywhere otherwise); returns the shift."""
    head = model.layer["out"][1]
    kept = {}
    hook = head.register_forward_hook(lambda m, i, o: kept.__setitem__("logits", o.detach()))
    type(model).infer_batch_device(model, batch)
    hook.remove()
    diff = kept["logits"][:, 1] - kept["logits"][:, 0]
    shift = float(diff.float().median())
    with torch.no_grad():
        head.bias[1] -= shift / 2
        head.bias[0] += shift / 2
    return shift


def check_energy_view(canvas_obj, h: int, w: int) -> dict:
    """K5's view entry (the generic fetch's call, after K3) against its plain
    version on the run's normalised canvas, and its times."""
    normalized = canvas_ops.normalize_rows(canvas_obj.canvas, canvas_obj.count, 0, h, w)
    view = normalized[..., 1:3]
    err = float((energy_ops.hv_energy(view) - energy_ops.hv_energy_reference(view)).abs().max())
    check(err <= ENERGY_TOL, f"hv_energy vs plain max abs diff {err} > {ENERGY_TOL}")
    library = energy_library(view)

    n_pix = h * w
    bytes_s = (ENERGY_BYTES_IN + 4) * n_pix / HBM_BYTES_PER_S
    ops_s = ENERGY_OPS_PER_PIX * n_pix / FP32_OPS_PER_S
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: energy_ops.hv_energy(view), 20),
        "plain_ms": time_ms(lambda: energy_ops.hv_energy_reference(view), 10),
        "library_ms": time_ms(library, 10),
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "shape": [h, w],
    }


def instances_per_task(instances: dict) -> dict:
    """Instances of each task."""
    tasks = [v.get("task_type") for v in instances.values()]
    return {t: tasks.count(t) for t in sorted(set(tasks), key=str)}


def phase_nucleus_zoo(slide: Path, tmp: Path, card: str) -> list[dict]:
    """MicroNet on the spill phase's slide (0.25 mpp, per-patch feed: its own
    preproc) and HoVer-Net+ on phase A/B's slide (0.5 mpp, region feed, the
    generic fetch), both on the multitask engine."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    gen = torch.Generator(device=DEVICE).manual_seed(17)

    # MicroNet: K2 per batch, K3 at the fetch
    micro_slide = tmp / "config5.tiff"
    if not micro_slide.exists():
        make_synthetic_slide(micro_slide, size=SPILL_SLIDE_WH, mpp=0.25, objective_power=40)
    model, ioconfig = get_pretrained_model(MICRONET_MODEL, device=DEVICE)
    first, dataset = first_patches(model, micro_slide, ioconfig, DETECT_BATCH)
    shift = temper_micronet(model, first)
    engine = MultiTaskSegmentor(model, batch_size=DETECT_BATCH, verbose=False)
    recorder = CanvasRecorder(-(-len(dataset) // DETECT_BATCH), (DETECT_BATCH, *ioconfig.patch_output_shape, 2))
    result, counts, seconds, peak, summary = zoo_run(engine, micro_slide, ioconfig, recorder, "multitask-device-canvas")
    check_launched(counts, ("scatter_accumulate", "normalize_rows"), MICRONET_MODEL)
    instances = result["instances"]
    check(len(instances) > 0, "MicroNet: no instances")
    check(all(len(v["contours"]) >= 3 for v in instances.values()), "MicroNet contours of 3 points or more")
    w, h = SPILL_SLIDE_WH
    scatter_err = restitch_canvas(recorder)[0]
    cpu_model = type(model)(**PRETRAINED_MODELS[MICRONET_MODEL]["architecture"]["kwargs"], device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_err = held_against_cpu(model, cpu_model, first[:2], recorder.calls[0][0][:2])
    check(cpu_err <= CPU_REL_TOL, f"MicroNet card vs CPU: {cpu_err} of the max > {CPU_REL_TOL}")
    del cpu_model
    scatter = check_scatter(recorder, gen, ragged=False)
    normalize = check_normalize(recorder.canvas, h, w)
    scatter["max_abs_err"] = max(scatter["max_abs_err"], scatter_err)
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    emit(
        {
            "phase": "nucleus_zoo",
            "model": MICRONET_MODEL,
            "path": summary["path"],
            "slide_wh": [w, h],
            "seconds": seconds,
            "patches": n_patches,
            "patches_per_s": n_patches / seconds,
            "instances": len(instances),
            "instances_per_s": len(instances) / seconds,
            "output_bias_shift": shift,
            "peak_memory_bytes": peak,
            "launches": counts,
            "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
            "cpu_relative_max_abs_diff": cpu_err,
            "restitch_scatter_max_abs_err": scatter_err,
            "kernels": {"scatter_accumulate": scatter, "normalize_rows": normalize},
            "card": card,
        }
    )
    rows += zoo_rows(MICRONET_MODEL, counts, {"scatter_accumulate": scatter, "normalize_rows": normalize})
    del recorder
    model.to("cpu")

    # HoVer-Net+: K4 and K2 on the region feed, K3 then K5 at the generic fetch
    model, ioconfig = get_pretrained_model(PLUS_MODEL, device=DEVICE)
    kwargs = PRETRAINED_MODELS[PLUS_MODEL]["architecture"]["kwargs"]
    # the nucleus branches from the functional HoVer-Net checkpoint, the layer branch seeded
    model.load_state_dict({**model.state_dict(), **functional_hovernet_state_dict(num_types=3, mode="fast")})
    first, dataset = first_patches(model, slide, ioconfig, PLUS_BATCH)
    HoVerNetPlus.infer_batch_device(model, first)  # warm-up
    plan = region_ops.BandPlan.build(np.asarray(dataset.inputs), dataset.patch_input_shape, dataset.stride_shape)
    n_slots = -(-len(dataset) // PLUS_BATCH) + len(plan.bands)
    engine = MultiTaskSegmentor(model, batch_size=PLUS_BATCH, verbose=False)
    recorder = CanvasRecorder(n_slots, (PLUS_BATCH, *ioconfig.patch_output_shape, 5))
    result, counts, seconds, peak, summary = zoo_run(
        engine, slide, ioconfig, recorder, "multitask-device-canvas+region-feed+device-energy"
    )
    check_launched(counts, ("scatter_accumulate", "normalize_rows", "extract_patches", "hv_energy"), PLUS_MODEL)
    check(not model.banded_fetch_spec([1, 2, 1, 1]), "HoVer-Net+ takes the generic fetch")
    instances = result["instances"]
    per_task = instances_per_task(instances)
    layers = np.asarray(result["semantic_predictions"]["layer_segmentation"])
    w, h = SLIDE_WH
    check(layers.shape == (h, w), f"layer map {layers.shape}")
    check(per_task.get("nuclei_segmentation", 0) > 0 and per_task.get("layer_segmentation", 0) > 0,
          f"HoVer-Net+ instances per task {per_task}")
    scatter_err = restitch_canvas(recorder)[0]
    cpu_model = HoVerNetPlus(**kwargs, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        card_logits = model(model.stage_batch(first[:2]).float())
        cpu_logits = cpu_model(torch.from_numpy(first[:2]).float())
    card_heads = HoVerNetPlus._head_outputs(card_logits)
    cpu_heads = HoVerNetPlus._head_outputs(cpu_logits)
    compared = {
        "np": (card_heads[0], cpu_heads[0]),
        "hv": (card_heads[1], cpu_heads[1]),
        # the seeded layer branch's top two classes are often a hair apart, so
        # its softmax is held, not its argmax
        **{f"{head}_softmax": (torch.softmax(card_logits[head].float(), -1), torch.softmax(cpu_logits[head].float(), -1))
           for head in ("tp", "ls")},
    }
    cpu_errs = {
        name: float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30) for name, (a, b) in compared.items()
    }
    check(max(cpu_errs.values()) <= CPU_REL_TOL, f"HoVer-Net+ card vs CPU {cpu_errs}")
    ls_agree = float((card_logits["ls"].argmax(-1).cpu() == cpu_logits["ls"].argmax(-1)).float().mean())
    del cpu_model
    scatter = check_scatter(recorder, gen, ragged=False)
    normalize = check_normalize(recorder.canvas, h, w)
    extract = check_extract(slide, dataset, plan, PLUS_BATCH)
    energy = check_energy_view(recorder.canvas, h, w)
    scatter["max_abs_err"] = max(scatter["max_abs_err"], scatter_err)
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    measured = {"scatter_accumulate": scatter, "normalize_rows": normalize, "extract_patches": extract, "hv_energy": energy}
    emit(
        {
            "phase": "nucleus_zoo",
            "model": PLUS_MODEL,
            "path": summary["path"],
            "slide_wh": [w, h],
            "seconds": seconds,
            "patches": n_patches,
            "patches_per_s": n_patches / seconds,
            "instances_per_task": per_task,
            "instances_per_s": len(instances) / seconds,
            "layer_pixel_counts": np.bincount(layers.ravel(), minlength=5).tolist(),
            "peak_memory_bytes": peak,
            "launches": counts,
            "n_bands": summary.get("n_bands"),
            "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
            "cpu_relative_max_abs_diff": cpu_errs,
            "cpu_layer_agreement": ls_agree,
            "restitch_scatter_max_abs_err": scatter_err,
            "kernels": measured,
            "card": card,
        }
    )
    rows += zoo_rows(PLUS_MODEL, counts, measured)
    del recorder
    model.to("cpu")
    return rows


# -- the patch-classifier zoo and feature extraction ------------------------------

ZOO_BATCH = 64  # one batch at each registry input shape, and the engines' batch
ZOO_SIZES = {"kather100k": (224, 0.5), "pcam": (96, 1.0)}  # registry patch side and mpp
ZOO_PREDICT_MODEL = "densenet161-kather100k"
ZOO_IDARS_MODEL = "resnet18-idars-msi"
ZOO_CPU_PATCHES = 2  # patches held against the CPU
ZOO_SOFTMAX_TOL = 1e-3
# the checks against the CPU mean something only where the outputs depend on
# the patch: the least std over patches of a probability, and of a feature
# over the largest |feature|
ZOO_MIN_SPREAD = 1e-3
FEATURE_MIN_SPREAD = 1e-3
# seeded layer-scale gammas start at 1e-5, so that the blocks hardly touch the
# CLS token; the smoke sets them here, near a trained encoder's scale
VIT_LAYER_SCALE = 0.5
FEATURE_TOL = 1e-4  # features, card against the CPU, of their largest |feature|
VIT_BATCH = 16


def zoo_backbones() -> list[str]:
    """The registry's classifier backbones, in registry order."""
    seen = []
    for cfg in PRETRAINED_MODELS.values():
        if cfg["architecture"]["class"] == "vanilla.CNNModel" and cfg["architecture"]["kwargs"]["backbone"] not in seen:
            seen.append(cfg["architecture"]["kwargs"]["backbone"])
    return seen


def grid_patches(slide: Path, side: int, mpp: float, n: int) -> tuple[np.ndarray, WSIPatchDataset]:
    """The first ``n`` patches of the Otsu-masked ``side``^2 grid at ``mpp``, and the grid."""
    dataset = WSIPatchDataset(slide, patch_input_shape=(side, side), stride_shape=(side, side), resolution=mpp, units="mpp")
    return np.stack([dataset[i]["image"] for i in range(min(n, len(dataset)))]), dataset


def on_cpu(model, batch: torch.Tensor):
    """``model``'s forward on the CPU with a CPU copy of its parameters and
    buffers (``torch.func.functional_call``): the same model, no second build."""
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    with torch.inference_mode():
        return torch.func.functional_call(model, state, (batch,))


def held_probs(model, patches: np.ndarray, card: np.ndarray | None = None) -> tuple[float, float]:
    """The first patches' softmax on the card (``card``, else computed here)
    against the CPU (largest difference), and their logits' largest
    difference over the largest |logit|."""
    x = patches[:ZOO_CPU_PATCHES]
    if card is None:
        card = type(model).infer_batch(model, x)
    staged = model_ready(x)
    cpu_logits = on_cpu(model, staged)
    with torch.inference_mode():
        card_logits = model(staged.to(model.device)).cpu()
    cpu = torch.softmax(cpu_logits.float(), dim=-1).numpy()
    logit_rel = float((card_logits - cpu_logits).abs().max()) / max(float(cpu_logits.abs().max()), 1e-30)
    return float(np.abs(card[:ZOO_CPU_PATCHES] - cpu).max()), logit_rel


def zoo_forward(name: str, patches: np.ndarray) -> dict:
    """A registry classifier on the card: seeded, batch norm calibrated, one
    batch of ``ZOO_BATCH`` at its registry shape; the first patches against the CPU."""
    model, ioconfig = get_pretrained_model(name, device=DEVICE)
    check(tuple(ioconfig.patch_input_shape) == patches.shape[1:3], f"{name} input {ioconfig.patch_input_shape}")
    calibrate_batch_norm(model, patches)
    batch = torch.from_numpy(patches).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probs = CNNModel.infer_batch_device(model, batch).cpu().numpy()
    peak = int(torch.cuda.max_memory_allocated())
    n_classes = model.num_classes
    check(probs.shape == (len(patches), n_classes) and bool(np.isfinite(probs).all()), f"{name} probabilities")
    forward_ms = time_ms(lambda: CNNModel.infer_batch_device(model, batch), 5)
    cpu_err, logit_rel = held_probs(model, patches)
    check(cpu_err <= ZOO_SOFTMAX_TOL, f"{name} card vs CPU softmax {cpu_err} > {ZOO_SOFTMAX_TOL}")
    return {
        "forward_ms_per_batch": forward_ms,
        "patches_per_s": len(patches) / forward_ms * 1e3,
        "peak_memory_bytes": peak,
        "cpu_max_abs_diff": cpu_err,
        "cpu_logit_rel_diff": logit_rel,
        "prob_std_over_patches": float(probs.std(axis=0).max()),
    }


def zoo_predict(name: str, slide: Path, first: np.ndarray, expected: WSIPatchDataset) -> dict:
    """``PatchPredictor(<registry name>)`` over the whole slide (Otsu mask,
    kather100k ioconfig); counts, coordinates, rows and the CPU checked."""
    model, ioconfig = get_pretrained_model(name, device=DEVICE)
    host = np.stack([model.preproc_func(p) for p in first])
    calibrate_batch_norm(model, host)
    type(model).infer_batch(model, host[:ZOO_CPU_PATCHES])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    predictor = PatchPredictor(model=model, batch_size=ZOO_BATCH, verbose=False)
    output = predictor.run([slide], patch_mode=False, ioconfig=ioconfig)[str(slide)]
    seconds = time.perf_counter() - t0
    counts = all_counts()
    peak = int(torch.cuda.max_memory_allocated())
    probs = output["probabilities"]
    check(len(probs) == len(expected) == PREDICT_PATCHES, f"{name} patch count {len(probs)}")
    check(np.array_equal(output["coordinates"], expected.inputs), f"{name} coordinates")
    check(probs.shape == (len(expected), model.num_classes) and bool(np.isfinite(probs).all()), f"{name} shape")
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    check(row_err <= 1e-4, f"{name} rows sum to 1 within {row_err}")
    check(np.array_equal(output["predictions"], probs.argmax(axis=1)), f"{name} predictions")
    # the run's first patches (the grid's, in order) against the CPU
    cpu_err, logit_rel = held_probs(model, host, probs)
    check(cpu_err <= ZOO_SOFTMAX_TOL, f"{name} card vs CPU softmax {cpu_err} > {ZOO_SOFTMAX_TOL}")
    spread = float(probs.std(axis=0).max())
    check(spread >= ZOO_MIN_SPREAD, f"{name} probabilities hardly depend on the patch: std {spread}")
    return {
        "model": name,
        "seconds": seconds,
        "patches": int(len(probs)),
        "patches_per_s": len(probs) / seconds,
        "peak_memory_bytes": peak,
        "stages": predictor.stages,
        "launches": counts,
        "cpu_max_abs_diff": cpu_err,
        "cpu_logit_rel_diff": logit_rel,
        "prob_std_over_patches": spread,
        "input_dtype": str(host.dtype),
        "class_counts": np.bincount(output["predictions"], minlength=model.num_classes).tolist(),
    }


def phase_classifier_zoo(slide: Path, card: str) -> None:
    """Every registry classifier backbone at full width, one batch at each of
    its registry input shapes; then PatchPredictor over the A/B slide with
    densenet161-kather100k and with an IDaRS entry (float host preproc)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    patches = {ds: grid_patches(slide, side, mpp, ZOO_BATCH)[0] for ds, (side, mpp) in ZOO_SIZES.items()}
    for ds, batch in patches.items():
        check(len(batch) == ZOO_BATCH, f"{ds} grid has {len(batch)} patches")
    rows = {}
    for backbone in zoo_backbones():
        rows[backbone] = {ds: zoo_forward(f"{backbone}-{ds}", batch) for ds, batch in patches.items()}
        torch.cuda.empty_cache()
    first, expected = grid_patches(slide, PATCH, 0.5, ZOO_BATCH)
    runs = [zoo_predict(name, slide, first, expected) for name in (ZOO_PREDICT_MODEL, ZOO_IDARS_MODEL)]
    check(runs[1]["input_dtype"] == "float32", "the IDaRS preproc gives float patches")
    emit(
        {
            "phase": "zoo",
            "seconds": time.perf_counter() - t_start,
            "backbones": len(rows),
            "forward": rows,
            "predict": runs,
            "card": card,
        }
    )


class KeepingExtractor(DeepFeatureExtractor):
    """The feature engine, keeping what it saves."""

    def save_predictions(self, processed_predictions: dict, output_type: str, save_dir=None, output_file=None, **kwargs):
        self.kept = processed_predictions
        return super().save_predictions(processed_predictions, output_type, save_dir, output_file, **kwargs)


def vit_gflop_per_patch(name: str, side: int = PATCH) -> float:
    """Multiply-adds x 2 of a ``VIT_CONFIGS`` encoder on one side^2 patch:
    the patch embedding, and per block the qkv and output projections, the
    two attention products and the MLP (SwiGLU's packed fc1 is twice as wide)."""
    cfg = VIT_CONFIGS[name]
    p, dim = cfg["patch_size"], cfg["embed_dim"]
    grid = -(-side // p)
    tokens = grid * grid + 1 + cfg.get("reg_tokens", 0)
    hidden = int(dim * cfg.get("mlp_ratio", 4.0))
    mlp = (3 if cfg.get("swiglu") else 2) * dim * hidden
    block = 2 * tokens * (4 * dim * dim + mlp) + 4 * tokens * tokens * dim
    return (2 * p * p * 3 * dim * grid * grid + cfg["depth"] * block) / 1e9


def temper_vit(model) -> None:
    """Set a seeded ViT's layer-scale gammas to ``VIT_LAYER_SCALE``."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith(("ls1.gamma", "ls2.gamma")):
                param.fill_(VIT_LAYER_SCALE)


def feature_run(model, slide: Path, ioconfig, first: np.ndarray, expected: WSIPatchDataset, out: Path) -> dict:
    """``DeepFeatureExtractor`` over the slide to zarr, read back equal, the
    first patches against the CPU; the forward of one batch on the card."""
    if any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()):
        calibrate_batch_norm(model, first)
    temper_vit(model)
    type(model).infer_batch(model, first[:ZOO_CPU_PATCHES])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    engine = KeepingExtractor(model=model, batch_size=ZOO_BATCH, verbose=False)
    written = engine.run([slide], patch_mode=False, ioconfig=ioconfig, save_dir=out, output_type="zarr")[str(slide)]
    seconds = time.perf_counter() - t0
    counts = all_counts()
    peak = int(torch.cuda.max_memory_allocated())
    group = open_zarr(written)
    features, coords = group["features"][:], group["coordinates"][:]
    KEPT.setdefault("features", {"path": Path(written), "model": model.backbone})
    check(np.array_equal(features, engine.kept["features"]), "zarr features read back equal")
    check(np.array_equal(coords, engine.kept["coordinates"]), "zarr coordinates read back equal")
    check(features.shape == (len(expected), model.num_features), f"features shape {features.shape}")
    check(np.array_equal(coords, expected.inputs), "feature coordinates equal the predictor's grid")
    check(bool(np.isfinite(features).all()), "features finite")
    cpu = on_cpu(model, torch.from_numpy(first[:ZOO_CPU_PATCHES]).float().div_(255.0)).numpy()
    cpu_rel = float(np.abs(features[:ZOO_CPU_PATCHES] - cpu).max()) / max(float(np.abs(cpu).max()), 1e-30)
    check(cpu_rel <= FEATURE_TOL, f"{model.backbone} features card vs CPU {cpu_rel} > {FEATURE_TOL}")
    spread = float(features.std(axis=0).max()) / max(float(np.abs(features).max()), 1e-30)
    check(spread >= FEATURE_MIN_SPREAD, f"{model.backbone} features hardly depend on the patch: {spread}")
    on_card = torch.from_numpy(first).to(DEVICE)
    forward_ms = time_ms(lambda: type(model).infer_batch_device(model, on_card), 3)
    return {
        "model": f"{type(model).__name__}({model.backbone})",
        "seconds": seconds,
        "patches": int(len(features)),
        "features_per_s": len(features) / seconds,
        "width": int(model.num_features),
        "zarr_bytes": disk_bytes(written),
        "peak_memory_bytes": peak,
        "stages": engine.stages,
        "launches": counts,
        "cpu_relative_max_abs_diff": cpu_rel,
        "feature_relative_std_over_patches": spread,
        "forward_ms_per_batch": forward_ms,
        "forward_batch": len(first),
    }


def vit_forward(name: str, batch: torch.Tensor, first: np.ndarray) -> dict:
    """A ``VIT_CONFIGS`` encoder at full width on the card: one batch."""
    torch.cuda.reset_peak_memory_stats()
    model = TimmBackbone(name, device=DEVICE)
    temper_vit(model)
    feats = TimmBackbone.infer_batch_device(model, batch)
    torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated())
    width = VIT_CONFIGS[name]["embed_dim"]
    check(tuple(feats.shape) == (len(batch), width), f"{name} features {tuple(feats.shape)}")
    check(bool(torch.isfinite(feats).all()), f"{name} features finite")
    forward_ms = time_ms(lambda: TimmBackbone.infer_batch_device(model, batch), 3)
    gflop = vit_gflop_per_patch(name)
    row = {
        "shape": list(feats.shape),
        "finite": True,
        "parameters": sum(p.numel() for p in model.parameters()),
        "forward_ms_per_batch": forward_ms,
        "gflop_per_patch": gflop,
        "tflop_per_s": gflop * len(batch) / forward_ms,
        "peak_memory_bytes": peak,
    }
    if name == "H0-mini":  # registers and SwiGLU, held against the CPU too
        card = TimmBackbone.infer_batch(model, first[:ZOO_CPU_PATCHES])
        cpu = on_cpu(model, torch.from_numpy(first[:ZOO_CPU_PATCHES]).float().div_(255.0)).numpy()
        row["cpu_relative_max_abs_diff"] = float(np.abs(card - cpu).max()) / float(np.abs(cpu).max())
        check(row["cpu_relative_max_abs_diff"] <= FEATURE_TOL, f"H0-mini card vs CPU {row}")
    del model, feats
    torch.cuda.empty_cache()
    return row


def phase_features(slide: Path, tmp: Path, card: str) -> None:
    """DeepFeatureExtractor over the A/B slide with CNNBackbone("resnet50"),
    TimmBackbone("UNI") and TimmBackbone("efficientnet_b0"), each to zarr;
    then every other VIT_CONFIGS encoder at full width on one batch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    ioconfig = IOPatchPredictorConfig(**PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"])
    first, expected = grid_patches(slide, PATCH, 0.5, ZOO_BATCH)
    runs = []
    for cls, backbone in ((CNNBackbone, "resnet50"), (TimmBackbone, "UNI"), (TimmBackbone, "efficientnet_b0")):
        model = cls(backbone, device=DEVICE)
        runs.append(feature_run(model, slide, ioconfig, first, expected, tmp / f"features_{model.backbone}"))
        if backbone in VIT_CONFIGS:
            gflop = vit_gflop_per_patch(backbone)
            runs[-1].update(gflop_per_patch=gflop, tflop_per_s=gflop * len(first) / runs[-1]["forward_ms_per_batch"])
        del model
        torch.cuda.empty_cache()
    batch = torch.from_numpy(first[:VIT_BATCH]).to(DEVICE)
    vits = {name: vit_forward(name, batch, first) for name in VIT_CONFIGS if name != "UNI"}
    emit(
        {
            "phase": "features",
            "seconds": time.perf_counter() - t_start,
            "extract": runs,
            "vit_configs": vits,
            "card": card,
        }
    )


# -- the registry's tail: KongNet, the tissue masks, the tsef U-Net, NuClick ------

TAIL_KONGNET = "KongNet_CoNIC_1"  # on phase A/B's slide at 0.5 mpp: 17 x 13 patches of 256^2 at stride 248
# one batch each: MIDOG at 512^2 on phase A/B's slide, the 0.25 mpp entries on phase D's
TAIL_KONGNETS = ("KongNet_Det_MIDOG_1", "KongNet_MONKEY_1", "KongNet_PUMA_T1_3", "KongNet_PUMA_T2_3", "KongNet_PanNuke_1")
TAIL_BATCH = 16
# a 4096x3072 slide declared at 8 mpp holds 33 x 25 mm of tissue, a 40x
# slide's: 9 x 7 patches of 512^2 at stride 480 at 8 mpp (EfficientUNet),
# 12 x 9 at stride 256 at 10 mpp (GrandQC)
TISSUE_SLIDE_WH = (4096, 3072)
TISSUE_SLIDE_MPP = 8.0
TISSUE_MODELS = ("grandqc_tissue_detection", "efficientunet-tissue_mask")
TSEF_MODEL = "unet_tissue_mask_tsef"  # on phase D's slide at baseline: 13 x 9 patches of 1024^2 at stride 256
NUCLICK_MODELS = ("nuclick_original-pannuke", "nuclick_light-pannuke")
TAIL_CPU_TOL = 1e-3  # first-batch sigmoid / softmax maps, card against the CPU, absolute
TAIL_CPU_PATCHES = 2


def forward_gflop(model, batch: torch.Tensor) -> float:
    """GFLOP of one patch's forward (2 per multiply-add of the convolutions
    and matrix products, ``torch.utils.flop_counter``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        model(batch[:1])
    return counter.get_total_flops() / 1e9


def forward_timing(model, infer, batch: torch.Tensor) -> dict:
    """``infer(batch)``'s device time a batch, its GFLOP a patch and its TFLOP/s."""
    ms = time_ms(lambda: infer(batch), 5)
    gflop = forward_gflop(model, batch.float() if batch.dtype == torch.uint8 else batch)
    return {
        "forward_ms_per_batch": ms,
        "batch": int(batch.shape[0]),
        "gflop_per_patch": gflop,
        "tflop_per_s": gflop * batch.shape[0] / ms,
        "patches_per_s_forward": batch.shape[0] / ms * 1e3,
    }


def spread_patches(model, slide: Path, ioconfig, n: int) -> np.ndarray:
    """``n`` grid patches evenly spaced over ``slide`` (through the model's own
    preproc): the batch the seeded network's batch norms are calibrated on,
    tissue and background alike, where the grid's first patches are the top rows."""
    _, dataset = first_patches(model, slide, ioconfig, 1)
    picks = np.linspace(0, len(dataset) - 1, n).round().astype(int)
    return np.stack([dataset[int(i)]["image"] for i in picks])


def temper_heads(model, patches: np.ndarray, heads) -> float:
    """Scale the output convolutions so that ``patches``' logits lie within
    +-4: the seeded network's reach tens, where the sigmoid is flat at 0 and 1
    and a map's top quantile is a plateau. Returns the scale."""
    with torch.inference_mode():
        peak = float(model(torch.from_numpy(patches).to(model.device)).abs().max())
    scale = 4.0 / max(peak, 1e-30)
    with torch.no_grad():
        for head in heads:
            head.weight.mul_(scale)
            head.bias.mul_(scale)
    return scale


def centre_logits(model, patches: np.ndarray, head, probability: float) -> float:
    """Shift ``head``'s bias so that the median logit of ``patches`` is that of
    ``probability``: a seeded EfficientUNet's sigmoid never reaches the
    registry's 0.95 otherwise, and its mask would be empty. Returns the shift."""
    with torch.inference_mode():
        logits = model(torch.from_numpy(patches).to(model.device)).float()
    shift = float(np.log(probability / (1 - probability)) - logits.median())
    with torch.no_grad():
        head.bias.add_(shift)
    return shift


def kongnet_maps_on_cpu(model, patches: np.ndarray) -> np.ndarray:
    """The KongNet's target sigmoids for ``patches`` on the CPU (``on_cpu``)."""
    logits = on_cpu(model, torch.from_numpy(patches)).float()
    return torch.sigmoid(logits[..., model.target_channels]).numpy()


def hold_canvas_kernels(maps: torch.Tensor, stride: int, what: str) -> float:
    """K2 then K3 against their plain versions, bit for bit, on a batch's maps
    laid on a square grid at ``stride``; returns the largest difference."""
    n, ph, pw, n_ch = maps.shape
    side = int(np.ceil(np.sqrt(n)))
    pos = np.array([[(i // side) * stride, (i % side) * stride] for i in range(n)], np.int32)
    hw = (int(pos[:, 0].max()) + ph, int(pos[:, 1].max()) + pw)
    ok = np.ones(n, bool)

    def zeros(ch: int) -> torch.Tensor:
        return torch.zeros((*hw, ch), device=DEVICE)

    got = canvas_ops.scatter_accumulate(zeros(n_ch), zeros(1), maps, pos, ok)
    want = canvas_ops.scatter_accumulate_reference(zeros(n_ch), zeros(1), maps, pos, ok)
    return max(
        held_bitwise(got[0], want[0], f"{what} scatter canvas"),
        held_bitwise(got[1], want[1], f"{what} scatter count"),
        held_bitwise(
            canvas_ops.normalize_rows(*got, 0, hw[0], hw[1]),
            canvas_ops.normalize_rows_reference(*want, 0, hw[0], hw[1]),
            f"{what} normalised map",
        ),
    )


def release(*models) -> None:
    for model in models:
        model.to("cpu")
    torch.cuda.empty_cache()


def tail_kongnet(slide: Path, card: str, gen: torch.Generator) -> list[dict]:
    """KongNet_CoNIC_1 through ``NucleusDetector.run`` over phase A/B's slide:
    a first run for the threshold, then the timed run; the canvas stitched
    again with the plain K2 and K3, its detections those of the plain map,
    the first patches against the CPU."""
    model, ioconfig = get_pretrained_model(TAIL_KONGNET, device=DEVICE)
    first, dataset = first_patches(model, slide, ioconfig, TAIL_BATCH)
    spread = spread_patches(model, slide, ioconfig, TAIL_BATCH)
    calibrate_batch_norm(model, spread)
    head_scale = temper_heads(model, spread, [head[0] for head in model.heads])
    batch = torch.from_numpy(first).to(DEVICE)
    KongNet.infer_batch_device(model, batch)  # warm-up: cuDNN picks its algorithms
    engine = CanvasKeepingDetector(model, batch_size=TAIL_BATCH, verbose=False)
    n_ch = len(model.target_channels)
    recorder = CanvasRecorder(-(-len(dataset) // TAIL_BATCH), (TAIL_BATCH, *ioconfig.patch_output_shape, n_ch))
    # the first run only gives the map: no sigmoid exceeds 1, so it finds no peaks
    _, _, calib_seconds, _, _ = zoo_run(engine, slide, ioconfig, recorder, "device-canvas", threshold_abs=1.0)
    # the seeded network's sigmoid saturates at 1.0 on the zero-padded edge
    # patches: the threshold is taken among the values below that
    kept = engine.kept_canvas
    threshold = float(np.quantile(kept[kept < 1.0], DETECT_PEAK_QUANTILE))
    del kept
    found, counts, seconds, peak, summary = zoo_run(
        engine, slide, ioconfig, recorder, "device-canvas", threshold_abs=threshold
    )
    check_launched(counts, ("scatter_accumulate", "normalize_rows"), TAIL_KONGNET)
    canvas = engine.kept_canvas
    h, w = canvas.shape[:2]
    check(canvas.shape == (SLIDE_WH[1], SLIDE_WH[0], n_ch) and bool(np.isfinite(canvas).all()), f"map {canvas.shape}")
    n_found = len(found["coordinates"])
    check(n_found > 0 and set(np.unique(found["types"])) <= set(range(n_ch)), f"{TAIL_KONGNET} detections")
    scatter_err, plain_c, plain_n = restitch_canvas(recorder)
    plain_map = canvas_ops.normalize_rows_reference(plain_c, plain_n, 0, h, w).cpu().numpy()
    del plain_c, plain_n
    map_err = held_bitwise(torch.from_numpy(canvas), torch.from_numpy(plain_map), "kernel-normalised map == plain map")
    plain_found = engine.post_process_wsi({"probabilities": plain_map})
    for key in ("coordinates", "scores", "types"):
        check(np.array_equal(found[key], plain_found[key]), f"{TAIL_KONGNET} detections of the plain map: {key}")
    card_first = recorder.calls[0][0][:TAIL_CPU_PATCHES].numpy()
    cpu_err = float(np.abs(card_first - kongnet_maps_on_cpu(model, first[:TAIL_CPU_PATCHES])).max())
    check(cpu_err <= TAIL_CPU_TOL, f"{TAIL_KONGNET} card vs CPU maps {cpu_err} > {TAIL_CPU_TOL}")
    timing = forward_timing(model, lambda b: KongNet.infer_batch_device(model, b), batch)
    scatter = check_scatter(recorder, gen, ragged=False)
    normalize = check_normalize(recorder.canvas, h, w)
    scatter["max_abs_err"] = max(scatter["max_abs_err"], scatter_err)
    normalize["max_abs_err"] = max(normalize["max_abs_err"], map_err)
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    measured = {"scatter_accumulate": scatter, "normalize_rows": normalize}
    emit(
        {
            "phase": "registry_tail",
            "model": TAIL_KONGNET,
            "path": summary["path"],
            "slide_wh": [w, h],
            "seconds": seconds,
            "first_run_seconds": calib_seconds,
            "patches": n_patches,
            "patches_per_s": n_patches / seconds,
            "threshold_abs": threshold,
            "saturated_share": float((canvas == 1.0).mean()),
            "head_scale": head_scale,
            "detections": n_found,
            "detections_per_s": n_found / seconds,
            "detections_per_type": np.bincount(found["types"], minlength=n_ch).tolist(),
            **timing,
            "peak_memory_bytes": peak,
            "launches": counts,
            "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
            "cpu_max_abs_diff": cpu_err,
            "restitch_scatter_max_abs_err": scatter_err,
            "restitch_normalize_max_abs_err": map_err,
            "kernels": measured,
            "card": card,
        }
    )
    del recorder, engine
    release(model)
    return zoo_rows(TAIL_KONGNET, counts, measured)


def tail_kongnet_batches(slide: Path, slide_quarter: Path, card: str) -> None:
    """One batch of each other KongNet entry at its registry shape: timed,
    its first patch against the CPU, K2 and K3 held on its maps."""
    for name in TAIL_KONGNETS:
        model, ioconfig = get_pretrained_model(name, device=DEVICE)
        mpp = ioconfig.highest_input_resolution["resolution"]
        patches = spread_patches(model, slide if mpp == 0.5 else slide_quarter, ioconfig, TAIL_BATCH)
        calibrate_batch_norm(model, patches)
        temper_heads(model, patches, [head[0] for head in model.heads])
        batch = torch.from_numpy(patches).to(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        maps = KongNet.infer_batch_device(model, batch)
        peak = int(torch.cuda.max_memory_allocated())
        check(tuple(maps.shape) == (TAIL_BATCH, *ioconfig.patch_output_shape, len(model.target_channels)), name)
        check(bool(torch.isfinite(maps).all()), f"{name} maps finite")
        cpu_err = float(np.abs(maps[:1].cpu().numpy() - kongnet_maps_on_cpu(model, patches[:1])).max())
        check(cpu_err <= TAIL_CPU_TOL, f"{name} card vs CPU maps {cpu_err} > {TAIL_CPU_TOL}")
        stride = int(ioconfig.stride_shape[0])
        canvas_err = hold_canvas_kernels(maps, stride, name)
        emit(
            {
                "phase": "registry_tail",
                "model": name,
                "heads": len(model.heads),
                "wide_decoder": model.decoders[0].blocks[4].conv2[0].out_channels == 32,
                "patch": list(ioconfig.patch_input_shape),
                **forward_timing(model, lambda b: KongNet.infer_batch_device(model, b), batch),
                "peak_memory_bytes": peak,
                "map_std": float(maps.std()),
                "cpu_max_abs_diff": cpu_err,
                "canvas_kernels_max_abs_err": canvas_err,
                "card": card,
            }
        )
        release(model)


def tissue_cpu_maps(model, patches: np.ndarray) -> np.ndarray:
    """A tissue model's probabilities for ``patches`` on the CPU."""
    logits = on_cpu(model, torch.from_numpy(patches)).float()
    if isinstance(model, GrandQCModel):
        return torch.softmax(logits, dim=-1).numpy()
    return torch.sigmoid(logits).numpy()


def tail_tissue(name: str, slide: Path, card: str, gen: torch.Generator) -> list[dict]:
    """A tissue model through ``SemanticSegmentor.run`` (per-patch feed: its
    host preproc), its canvas stitched again with the plain versions, its
    ``postproc`` on the fetched map, its first patches against the CPU."""
    model, ioconfig = get_pretrained_model(name, device=DEVICE)
    first, dataset = first_patches(model, slide, ioconfig, TAIL_BATCH)
    spread = spread_patches(model, slide, ioconfig, TAIL_BATCH)
    calibrate_batch_norm(model, spread)
    temper_heads(model, spread, [model.segmentation_head[0]])
    if not isinstance(model, GrandQCModel):  # half the mask above EfficientUNet's threshold
        centre_logits(model, spread, model.segmentation_head[0], model.threshold)
    batch = torch.from_numpy(first).to(DEVICE)
    type(model).infer_batch_device(model, batch)  # warm-up
    n_ch = model.num_output_channels if isinstance(model, GrandQCModel) else 1
    engine = SemanticSegmentor(model, batch_size=TAIL_BATCH, verbose=False)
    recorder = CanvasRecorder(-(-len(dataset) // TAIL_BATCH), (TAIL_BATCH, *ioconfig.patch_output_shape, n_ch))
    result, counts, seconds, peak, summary = zoo_run(engine, slide, ioconfig, recorder, "device-canvas")
    check_launched(counts, ("scatter_accumulate", "normalize_rows"), name)
    probs = result["probabilities"]
    h, w = probs.shape[:2]
    want_w, want_h = WSIReader.open(slide).slide_dimensions(ioconfig.highest_input_resolution["resolution"], "mpp")
    check(probs.shape == (want_h, want_w, n_ch) and bool(np.isfinite(probs).all()), f"{name} map {probs.shape}")
    restitch = restitch_with_plain_versions(recorder, probs)
    t0 = time.perf_counter()
    mask = model.postproc(probs)
    postproc_seconds = time.perf_counter() - t0
    check(mask.shape == (h, w), f"{name} mask {mask.shape}")
    card_first = recorder.calls[0][0][:TAIL_CPU_PATCHES].numpy()
    cpu_err = float(np.abs(card_first - tissue_cpu_maps(model, first[:TAIL_CPU_PATCHES])).max())
    check(cpu_err <= TAIL_CPU_TOL, f"{name} card vs CPU maps {cpu_err} > {TAIL_CPU_TOL}")
    timing = forward_timing(model, lambda b: type(model).infer_batch_device(model, b), batch)
    scatter = check_scatter(recorder, gen, ragged=False)
    normalize = check_normalize(recorder.canvas, h, w)
    scatter["max_abs_err"] = max(scatter["max_abs_err"], restitch["scatter_max_abs_err"])
    normalize["max_abs_err"] = max(normalize["max_abs_err"], restitch["normalize_max_abs_err"])
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    measured = {"scatter_accumulate": scatter, "normalize_rows": normalize}
    emit(
        {
            "phase": "registry_tail",
            "model": name,
            "path": summary["path"],
            "canvas_wh": [w, h],
            "seconds": seconds,
            "patches": n_patches,
            "patches_per_s": n_patches / seconds,
            **timing,
            "peak_memory_bytes": peak,
            "mask_area_share": float(np.asarray(mask).astype(bool).mean()),
            "mask_pixels": int(np.count_nonzero(mask)),
            "postproc_seconds": postproc_seconds,
            "launches": counts,
            "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
            "cpu_max_abs_diff": cpu_err,
            "restitch": restitch,
            "kernels": measured,
            "card": card,
        }
    )
    del recorder, engine
    release(model)
    return zoo_rows(name, counts, measured)


def tail_tsef(slide_quarter: Path, card: str, gen: torch.Generator) -> list[dict]:
    """unet_tissue_mask_tsef on the region feed over phase D's slide (1024^2
    in, 512^2 out, stride 256: each canvas pixel covered four times), K4, K2
    and K3 held against their plain versions, one patch against the CPU."""
    model, ioconfig = get_pretrained_model(TSEF_MODEL, device=DEVICE)
    first, dataset = first_patches(model, slide_quarter, ioconfig, TAIL_BATCH)
    temper_random_weights(model)
    calibrate_batch_norm(model, spread_patches(model, slide_quarter, ioconfig, TAIL_BATCH))
    UNetModel.infer_batch_device(model, first[:2])  # warm-up
    plan = region_ops.BandPlan.build(np.asarray(dataset.inputs), dataset.patch_input_shape, dataset.stride_shape)
    n_slots = -(-len(dataset) // TAIL_BATCH) + len(plan.bands)
    n_ch = model.num_output_channels
    engine = SemanticSegmentor(model, batch_size=TAIL_BATCH, verbose=False)
    recorder = CanvasRecorder(n_slots, (TAIL_BATCH, *ioconfig.patch_output_shape, n_ch))
    result, counts, seconds, peak, summary = zoo_run(
        engine, slide_quarter, ioconfig, recorder, "device-canvas+region-feed"
    )
    check_launched(counts, ("scatter_accumulate", "normalize_rows", "extract_patches"), TSEF_MODEL)
    probs, preds = result["probabilities"], result["predictions"]
    w, h = INST_SLIDE_WH
    check(probs.shape == (h, w, n_ch) and bool(np.isfinite(probs).all()), f"tsef map {probs.shape}")
    covered = probs.sum(axis=-1) > 0
    row_err = float(np.abs(probs.sum(axis=-1)[covered] - 1.0).max())
    check(row_err <= 1e-5, f"tsef covered pixels sum to 1 within {row_err}")
    restitch = restitch_with_plain_versions(recorder, probs)
    check(restitch["max_count"] == 4.0, f"tsef overlap {restitch['max_count']}")
    x = model_ready(first[:1])
    with torch.inference_mode():
        card_logits = model(x.to(DEVICE)).float().cpu()
    cpu_logits = on_cpu(model, x).float()
    cpu_err = float((torch.softmax(card_logits, -1) - torch.softmax(cpu_logits, -1)).abs().max())
    check(cpu_err <= TAIL_CPU_TOL, f"tsef card vs CPU softmax {cpu_err} > {TAIL_CPU_TOL}")
    timing = forward_timing(model, lambda b: UNetModel.infer_batch_device(model, b), torch.from_numpy(first).to(DEVICE))
    scatter = check_scatter(recorder, gen, ragged=False)
    normalize = check_normalize(recorder.canvas, h, w)
    extract = check_extract(slide_quarter, dataset, plan, TAIL_BATCH)
    scatter["max_abs_err"] = max(scatter["max_abs_err"], restitch["scatter_max_abs_err"])
    normalize["max_abs_err"] = max(normalize["max_abs_err"], restitch["normalize_max_abs_err"])
    n_patches = sum(int(np.count_nonzero(valid)) for *_, valid in recorder.calls)
    measured = {"scatter_accumulate": scatter, "normalize_rows": normalize, "extract_patches": extract}
    emit(
        {
            "phase": "registry_tail",
            "model": TSEF_MODEL,
            "path": summary["path"],
            "slide_wh": [w, h],
            "seconds": seconds,
            "patches": n_patches,
            "patches_per_s": n_patches / seconds,
            **timing,
            "peak_memory_bytes": peak,
            "n_bands": summary.get("n_bands"),
            "class_counts": np.bincount(preds.ravel(), minlength=n_ch).tolist(),
            "launches": counts,
            "stages": {k: v for k, v in summary.items() if isinstance(v, dict)},
            "cpu_softmax_max_abs_diff": cpu_err,
            "restitch": restitch,
            "kernels": measured,
            "card": card,
        }
    )
    del recorder, engine
    release(model)
    return zoo_rows(TSEF_MODEL, counts, measured)


def click_inputs(patches: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """NuClick's 5-channel input in [0, 1] (RGB / 255, a seeded inclusion click
    and two exclusion clicks a patch) and the inclusion maps."""
    n, h, w = patches.shape[:3]
    rng = np.random.default_rng(seed)
    points = rng.integers(8, [h - 8, w - 8], (n, 3, 2))
    inc = np.zeros((n, h, w), np.float32)
    exc = np.zeros((n, h, w), np.float32)
    idx = np.arange(n)
    inc[idx, points[:, 0, 0], points[:, 0, 1]] = 1
    for j in (1, 2):
        exc[idx, points[:, j, 0], points[:, j, 1]] = 1
    rgb = patches.astype(np.float32) / 255
    return np.concatenate([rgb, inc[..., None], exc[..., None]], axis=-1), inc


def tail_nuclick(slide: Path, card: str) -> None:
    """Both NuClick entries on one batch of 128^2 patches of phase A/B's slide
    (baseline 0.25) with seeded clicks: timed, against the CPU, then ``postproc``."""
    for name in NUCLICK_MODELS:
        model, ioconfig = get_pretrained_model(name, device=DEVICE)
        patches, _ = first_patches(model, slide, ioconfig, TAIL_BATCH)
        x01, inc = click_inputs(patches, seed=23)
        calibrate_batch_norm(model, x01)
        light = isinstance(model, UNetModel)
        # the U-Net divides its wire by 255, NuClick takes [0, 1]
        batch = torch.from_numpy(x01 * 255 if light else x01).to(DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = type(model).infer_batch_device(model, batch)
        peak = int(torch.cuda.max_memory_allocated())
        check(bool(torch.isfinite(out).all()), f"{name} output finite")
        with torch.inference_mode():
            card_logits = model(torch.from_numpy(x01[:TAIL_CPU_PATCHES]).to(DEVICE)).float().cpu()
        cpu_logits = on_cpu(model, torch.from_numpy(x01[:TAIL_CPU_PATCHES])).float()
        logit_rel = float((card_logits - cpu_logits).abs().max()) / max(float(cpu_logits.abs().max()), 1e-30)
        cpu_err = float((torch.sigmoid(card_logits) - torch.sigmoid(cpu_logits)).abs().max())
        check(cpu_err <= TAIL_CPU_TOL, f"{name} card vs CPU sigmoid of the logits {cpu_err} > {TAIL_CPU_TOL}")
        host = out.cpu().numpy()
        t0 = time.perf_counter()
        if light:
            masks = UNetModel.postproc(host)
        else:
            masks = NuClick.postproc(host, nuc_points=inc, do_reconstruction=True)
        postproc_seconds = time.perf_counter() - t0
        emit(
            {
                "phase": "registry_tail",
                "model": name,
                "output_shape": list(host.shape),
                **forward_timing(model, lambda b: type(model).infer_batch_device(model, b), batch),
                "peak_memory_bytes": peak,
                "cpu_sigmoid_max_abs_diff": cpu_err,
                "cpu_logit_rel_diff": logit_rel,
                "postproc_seconds": postproc_seconds,
                "mask_pixels_per_patch": float(np.asarray(masks).reshape(len(masks), -1).sum(axis=1).mean()),
                "card": card,
            }
        )
        release(model)


def phase_registry_tail(slide: Path, tmp: Path, card: str) -> list[dict]:
    """The registry entries ported last, at full registry width: KongNet on the
    detector, GrandQC and EfficientUNet on the semantic engine, the tsef U-Net
    on the region feed, NuClick on one batch. Returns the K2-K4 rows at their shapes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    slide_quarter = tmp / "nuclei.tiff"  # phase D's, 0.25 mpp
    check(slide_quarter.exists(), "phase D's slide")
    golden = check_grandqc_golden()
    rows = tail_kongnet(slide, card, gen)
    tail_kongnet_batches(slide, slide_quarter, card)
    t0 = time.perf_counter()
    tissue_slide = make_synthetic_slide(
        tmp / "tissue.tiff", size=TISSUE_SLIDE_WH, mpp=TISSUE_SLIDE_MPP, objective_power=1.25, seed=61,
        compression="deflate",
    )
    tissue_slide_seconds = time.perf_counter() - t0
    for name in TISSUE_MODELS:
        rows += tail_tissue(name, tissue_slide, card, gen)
    rows += tail_tsef(slide_quarter, card, gen)
    tail_nuclick(slide, card)
    emit(
        {
            "phase": "registry_tail",
            "seconds": time.perf_counter() - t_start,
            "tissue_slide_seconds": tissue_slide_seconds,
            "grandqc_golden": golden,
            "card": card,
        }
    )
    return rows


# -- phase A's stain API completed: Reinhard, Vahadane, stain augmentation --------

# K7 reads 3 bytes and writes 3 a pixel, as K1, and does 2 more float32
# operations a stain (the factor and the offset) than K1's scale
AUGMENT_OPS_PER_PIX = STAIN_OPS_PER_PIX + 2
AUGMENT_SIGMAS = (0.4, 0.2)


def held_augment(tiles: torch.Tensor, args, what: str) -> tuple[int, float]:
    """K7 on ``tiles`` against its plain version with the same factors: max
    abs difference and identical share; fails past 1 level or under 99.9 %."""
    got = stain_augment(tiles, *args)
    want = stain_augment_reference(tiles, *args)
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    diff = (got.int() - want.int()).abs()
    max_err = int(diff.max())
    identical = float((diff == 0).double().mean())
    check(max_err <= 1, f"K7 {what}: kernel vs plain max abs diff {max_err} > 1")
    check(identical >= 0.999, f"K7 {what}: kernel vs plain identical share {identical} < 0.999")
    return max_err, identical


def augment_args(stains: np.ndarray, n: int, gen: torch.Generator) -> tuple:
    """K7's arguments for ``n`` tiles: projection, stains, factors, offsets."""
    sigma1, sigma2 = AUGMENT_SIGMAS
    s = len(stains)
    alpha = torch.rand((n, s), generator=gen, device=DEVICE) * (2 * sigma1) + (1 - sigma1)
    beta = torch.rand((n, s), generator=gen, device=DEVICE) * (2 * sigma2) - sigma2
    proj = np.linalg.pinv(stains.T).T.astype(np.float32)
    return proj, stains.astype(np.float32), alpha, beta


def phase_stain_ext(slide: Path) -> dict:
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
    target = synthetic_he_patch((512, 512), seed=5)
    thumbnail = WSIReader.open(slide).slide_thumbnail()
    seconds: dict[str, float] = {}

    t = time.perf_counter()
    reinhard = get_normalizer("reinhard")
    reinhard.fit(target)
    seconds["reinhard_fit"] = time.perf_counter() - t
    t = time.perf_counter()
    vahadane = get_normalizer("vahadane")
    vahadane.fit(target)
    constants = vahadane.prepare_tile_transform(thumbnail)
    seconds["vahadane_fit"] = time.perf_counter() - t
    stains = vahadane.stain_matrix_target

    # main path, counted from zero: Reinhard on the host, Vahadane through
    # K1, augmentation through K7 with a seeded generator
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    stain_transform.launches = 0
    stain_augment.launches = 0
    seconds.update(reinhard_transform=0.0, vahadane_transform=0.0, augment=0.0)
    first = None
    n_patches = 0
    paths = set()
    pinned = DEVICE == "cuda"
    for batch in loader.iter_staged(lambda host: torch.as_tensor(host).to(DEVICE, non_blocking=True), pin_memory=pinned):
        tiles = batch["image"]
        t = time.perf_counter()
        host = tiles.cpu().numpy()
        reinhard_out = reinhard.transform_tiles(host)
        seconds["reinhard_transform"] += time.perf_counter() - t
        t = time.perf_counter()
        vahadane_out = vahadane.transform_tiles(tiles, constants)
        torch.cuda.synchronize()
        seconds["vahadane_transform"] += time.perf_counter() - t
        t = time.perf_counter()
        augmented = augment_tiles(tiles, stains, generator=gen)
        torch.cuda.synchronize()
        seconds["augment"] += time.perf_counter() - t
        paths.add(augment_path(tiles))
        if first is None:
            first = (tiles.clone(), reinhard_out, vahadane_out, augmented)
        n_patches += batch["n_valid"]
    k1_launches, k7_launches = stain_transform.launches, stain_augment.launches
    check(k7_launches == len(loader) and k7_launches > 0, f"K7 launches {k7_launches}")
    check(k1_launches == len(loader), f"K1 launches in Vahadane's transform {k1_launches}")
    tiles, reinhard_out, vahadane_out, augmented = first
    check(reinhard_out.shape == tuple(tiles.shape) and reinhard_out.dtype == np.uint8, "Reinhard output")
    check(tuple(vahadane_out.shape) == tuple(tiles.shape), "Vahadane output shape")
    check(tuple(augmented.shape) == (BATCH, PATCH, PATCH, 3), "augmented shape")
    check(bool((augmented != tiles).any()), "augmentation changed nothing")
    check(paths == {"tile_uniform"}, f"K7 paths on the main path {sorted(paths)}")

    # K7 against its plain version on the card: the main path's batch with
    # its own factors, every colour, ragged and misaligned inputs; the
    # tile-uniform path against the general one on the batch's own pixels
    main_args = augment_args(stains, len(tiles), torch.Generator(device=DEVICE).manual_seed(16))
    max_err, identical = held_augment(tiles, main_args, "main path batch")
    colours = all_colours().reshape(256, 256, 256, 3)
    sweep = held_augment(colours, augment_args(stains, 256, gen), "2^24 colours")
    ragged = {}
    cases = ragged_cases(tiles)
    for name, case in cases.items():
        view = case if case.ndim == 4 else case.reshape(case.shape[0], 1, 1, 3)
        ragged[name] = held_augment(view, augment_args(stains, view.shape[0], gen), name)
    hed = np.vstack([stains, np.cross(stains[0], stains[1])[None] / np.linalg.norm(np.cross(stains[0], stains[1]))])
    three_args = augment_args(np.abs(hed), len(tiles), gen)
    three = held_augment(tiles, three_args, "3 stains")
    misaligned = cases["batch_3_bytes_into_a_buffer"]
    path = augment_path(tiles)
    check(path == "tile_uniform" and augment_path(misaligned) == "general", "K7 paths of the batch and its view")
    for args in (main_args, three_args):
        fast, general = stain_augment(tiles, *args), stain_augment(misaligned, *args)
        check(torch.equal(fast, general), "K7 tile-uniform path vs general path on the main batch: not bit for bit")
    torch.cuda.synchronize()

    copies = [tiles.clone() for _ in range(8)]
    turn = iter(range(1 << 30))
    kernel_ms = time_ms(lambda: stain_augment(copies[next(turn) % 8], *main_args), 50)
    three_ms = time_ms(lambda: stain_augment(copies[next(turn) % 8], *three_args), 50)
    plain_ms = time_ms(lambda: stain_augment_reference(copies[next(turn) % 8], *main_args), 20)
    n_pix = tiles.numel() // 3
    bytes_s = STAIN_BYTES_PER_PIX * n_pix / HBM_BYTES_PER_S
    ops_s = AUGMENT_OPS_PER_PIX * n_pix / FP32_OPS_PER_S
    bound_ms = max(bytes_s, ops_s) * 1e3
    max_abs = max(max_err, sweep[0], three[0], *(e for e, _ in ragged.values()))
    row = {
        "name": "stain_augment",
        "route": "cuda",
        "source": "tiatoolbox_tpu_torch/csrc/stain.cu",
        "replaces": "tiatoolbox_tpu/tools/stainaugment.py:129",
        "launches": k7_launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": None,
        "ms_3_stains": three_ms,
        "path": path,
    }
    emit(
        {
            "phase": "stain_ext",
            "seconds": time.perf_counter() - t0,
            "patches": n_patches,
            "batches": len(loader),
            "stage_seconds": seconds,
            "reinhard_ms_per_patch": seconds["reinhard_transform"] / max(n_patches, 1) * 1e3,
            "vahadane_stain_matrix": np.asarray(stains).round(6).tolist(),
            "k1_launches": k1_launches,
            "k7_launches": k7_launches,
            "k7_max_abs_err": max_err,
            "k7_identical_share": identical,
            "k7_sweep_max_abs_err_and_identical_share": sweep,
            "k7_3_stains_max_abs_err_and_identical_share": three,
            "k7_ragged_max_abs_err_and_identical_share": ragged,
            "k7_ms": kernel_ms,
            "k7_ms_3_stains": three_ms,
            "k7_path": path,
            "k7_gb_per_s": STAIN_BYTES_PER_PIX * n_pix / kernel_ms / 1e6,
            "k7_share_of_bound": bound_ms / kernel_ms,
            "k7_plain_ms": plain_ms,
            "k7_bound_ms": bound_ms,
            "batch_shape": list(tiles.shape),
        }
    )
    return row


# -- the slide readers on the port's own codecs ---------------------------------

READER_TILE = 256


def aperio_description(wh: tuple[int, int], codec: str) -> str:
    w, h = wh
    return (
        f"Aperio Image Library v0.0.0\n{w}x{h} [0,0 {w}x{h}] ({READER_TILE}x{READER_TILE})"
        f" {codec}|AppMag = 20|MPP = 0.5"
    )


def timed_read(reader: WSIReader, wh: tuple[int, int]) -> tuple[np.ndarray, float]:
    t = time.perf_counter()
    region = reader.read_rect((0, 0), wh, resolution=0, units="level")
    return region, time.perf_counter() - t


def predictor_run(model: CNNModel, slide: Path, ioconfig, mask) -> tuple[dict, float]:
    t = time.perf_counter()
    predictor = PatchPredictor(model=model, batch_size=BATCH, verbose=False)
    out = predictor.run([slide], masks=[mask], patch_mode=False, ioconfig=ioconfig)[str(slide)]
    return out, time.perf_counter() - t


def phase_readers(slide: Path, tmp: Path, card: str) -> None:
    t0 = time.perf_counter()
    root = tmp / "readers"
    root.mkdir()
    deflate = WSIReader.open(slide)
    wh = tuple(int(v) for v in deflate.info.slide_dimensions)
    half_wh = tuple(int(v) for v in deflate.info.level_dimensions[1])
    base = deflate.read_rect((0, 0), wh, resolution=0, units="level")
    half = deflate.read_rect((0, 0), half_wh, resolution=1, units="level")
    grid = (wh[0] // READER_TILE, wh[1] // READER_TILE)
    check(grid[0] * READER_TILE == wh[0] and grid[1] * READER_TILE == wh[1], "whole tiles")

    t = time.perf_counter()
    jpeg_tiff = root / "jpeg.tiff"
    tiffio.TiffPyramidWriter(
        jpeg_tiff, tile_size=READER_TILE, description=aperio_description(wh, f"JPEG/RGB Q={JPEG_QUALITY}"),
        mpp=(0.5, 0.5), compression="jpeg", jpeg_quality=JPEG_QUALITY,
    ).write([base, half])
    mrxs = write_synthetic_mrxs(
        root / "slide", grid_nx=grid[0], grid_ny=grid[1], tile=READER_TILE, n_levels=2, mpp=0.5,
        level_images=[base, half], jpeg_quality=JPEG_QUALITY,
    )
    jpeg_dcm = make_synthetic_dicom(
        root / "jpeg.dcm", frame_size=READER_TILE, mpp=0.5, image=base, compression="jpeg",
        jpeg_quality=JPEG_QUALITY, offset_table=True,
    )
    native_dcm = make_synthetic_dicom(root / "native.dcm", frame_size=READER_TILE, mpp=0.5, image=base)
    group = ZarrGroup.create(root / "slide.zarr")
    group.from_array("0", base, chunks=(READER_TILE, READER_TILE, 3))
    group.from_array("1", half, chunks=(READER_TILE, READER_TILE, 3))
    axes = [
        {"name": "y", "type": "space", "unit": "micrometer"},
        {"name": "x", "type": "space", "unit": "micrometer"},
        {"name": "c", "type": "channel"},
    ]
    datasets = [
        {"path": str(i), "coordinateTransformations": [{"type": "scale", "scale": [0.5 * 2**i, 0.5 * 2**i, 1.0]}]}
        for i in range(2)
    ]
    group.attrs = {"multiscales": [{"version": "0.4", "axes": axes, "datasets": datasets}]}
    tiff_to_fsspec(slide, str(slide), root / "refs.json")
    write_seconds = time.perf_counter() - t

    jpeg_reader = WSIReader.open(jpeg_tiff)
    jpeg_base, jpeg_seconds = timed_read(jpeg_reader, wh)
    readers = {
        "mirax": (WSIReader.open(mrxs), MIRAXWSIReader, jpeg_base),
        "dicom_jpeg": (WSIReader.open(jpeg_dcm), DICOMWSIReader, jpeg_base),
        "dicom_native": (WSIReader.open(native_dcm), DICOMWSIReader, base),
        "ngff": (WSIReader.open(root / "slide.zarr"), NGFFWSIReader, base),
        "fsspec": (FsspecJsonWSIReader(root / "refs.json"), FsspecJsonWSIReader, base),
    }
    mpix = wh[0] * wh[1] / 1e6
    rates = {"tiff_jpeg": mpix / jpeg_seconds}
    for name, (reader, cls, want) in readers.items():
        check(isinstance(reader, cls), f"{name} opened as {type(reader).__name__}")
        check(tuple(reader.info.slide_dimensions) == wh, f"{name} dimensions {reader.info.slide_dimensions}")
        got, sec = timed_read(reader, wh)
        check(got.shape == want.shape and np.array_equal(got, want), f"{name} level 0 is not the TIFF's, bit for bit")
        rates[name] = mpix / sec
    check(np.array_equal(readers["mirax"][0].read_rect((0, 0), half_wh, resolution=1, units="level"),
                         jpeg_reader.read_rect((0, 0), half_wh, resolution=1, units="level")), "mirax level 1")

    # PatchPredictor through WSIReader.open over the JPEG TIFF, the MIRAX and
    # the JPEG DICOM slide, each with phase B's tissue mask (the DICOM
    # instance has one level, so its own thumbnail would differ)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ioconfig = IOPatchPredictorConfig(**PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"])
    mask = deflate.tissue_mask()
    model = CNNModel("resnet18", num_classes=9, seed=0)
    corners = [((i // 4) * PATCH, (i % 4) * PATCH) for i in range(8)]
    calibrate_batch_norm(model, np.stack([jpeg_base[y : y + PATCH, x : x + PATCH] for y, x in corners]))
    runs = {}
    for name, path in (("tiff_jpeg", jpeg_tiff), ("mirax", mrxs), ("dicom_jpeg", jpeg_dcm)):
        out, sec = predictor_run(model, path, ioconfig, mask)
        runs[name] = (out, sec)
    want = runs["tiff_jpeg"][0]
    n = len(want["probabilities"])
    check(n == PREDICT_PATCHES, f"readers phase kept {n} patches, not {PREDICT_PATCHES}")
    prob_err = {}
    for name in ("mirax", "dicom_jpeg"):
        got = runs[name][0]
        check(np.array_equal(got["coordinates"], want["coordinates"]), f"{name} patch coordinates")
        check(np.array_equal(got["predictions"], want["predictions"]), f"{name} predictions")
        prob_err[name] = float(np.abs(got["probabilities"] - want["probabilities"]).max())
        check(prob_err[name] <= 1e-6, f"{name} probabilities differ by {prob_err[name]}")
    emit(
        {
            "phase": "readers",
            "seconds": time.perf_counter() - t0,
            "write_seconds": write_seconds,
            "level0_mpix": mpix,
            "read_mpix_per_s": rates,
            "patches": n,
            "patches_per_s": {k: n / v[1] for k, v in runs.items()},
            "run_seconds": {k: v[1] for k, v in runs.items()},
            "prob_max_abs_diff": prob_err,
            "file_bytes": {
                "tiff_jpeg": jpeg_tiff.stat().st_size,
                "mirax_data": sum(f.stat().st_size for f in (root / "slide").iterdir()),
                "dicom_jpeg": jpeg_dcm.stat().st_size,
                "dicom_native": native_dcm.stat().st_size,
            },
            "card": card,
        }
    )
    shutil.rmtree(root)


JP2_SIDE = 4096  # the JPEG phase's level 0, its top-left 4096^2: 256 tiles of 256^2
JP2_TILE = 256
JP2_SEG_WH = (2048, 4096)  # the segmentor's crop, declared at 0.25 mpp: 8 patch rows, so 6 bands
JP2_ONE_THREAD_TILES = 32  # tiles timed on one thread
JP2_PHASE_LIMIT_S = 90.0  # twice the phase's budget
J2K_GOLDEN = ROOT / "tiatoolbox_tpu_torch" / "data" / "j2k_golden.npz"


def check_j2k_golden() -> dict:
    """The card machine's build of the JPEG 2000 decoder against the golden
    set that scripts/make_j2k_golden.py made with OpenCV: every stream's
    pixels bit for bit (the 9/7 ones too: the tolerance is 0 levels), and
    cv2's IMREAD_REDUCED_COLOR_{2,4,8} pixels from the decode shrunk."""
    g = np.load(J2K_GOLDEN)
    for i, name in enumerate(g["names"]):
        stream = g["blob"][g["offsets"][i] : g["offsets"][i + 1]].tobytes()
        want = g["pixels"][g["pixel_offsets"][i] : g["pixel_offsets"][i + 1]].reshape(g["shapes"][i])
        got = native.decode_j2k(stream)
        check(np.array_equal(got, want), f"J2K golden {name}: pixels differ from cv2's")
    full = native.decode_j2k(g["reduced_stream"].tobytes())
    for k, factor in enumerate(g["reduced_factors"]):
        want = g["reduced_pixels"][g["reduced_offsets"][k] : g["reduced_offsets"][k + 1]]
        got = shrink_linear_exact(full, int(factor))
        check(np.array_equal(got, want.reshape(g["reduced_shapes"][k])), f"J2K golden reduced by {factor}")
    return {"decode_cases": len(g["names"]), "reduced_cases": len(g["reduced_factors"])}


class J2kTiffWriter(tiffio.TiffPyramidWriter):
    """The port's TIFF writer with each tile a lossless JPEG 2000 codestream
    (``retag_compression`` then marks the pages Aperio 33005)."""

    def _encode_tile(self, tile: np.ndarray) -> bytes:
        return native.encode_j2k(tile, n_threads=1)


def retag_compression(path: Path, compression: int) -> None:
    """Set every IFD's Compression (259, SHORT, one value) to ``compression``."""
    data = bytearray(path.read_bytes())
    entry = struct.pack("<HHI", 259, 3, 1)
    at = data.find(entry)
    check(at >= 0, "a Compression tag to retag")
    while at >= 0:
        struct.pack_into("<H", data, at + 8, compression)
        at = data.find(entry, at + 12)
    path.write_bytes(bytes(data))


def j2k_dicom(path: Path, image: np.ndarray, frame: int) -> Path:
    """A DICOM instance with lossless JPEG 2000 frames (transfer syntax
    1.2.840.10008.1.2.4.90): the frames coded on threads, then written by
    ``make_synthetic_dicom``'s encapsulated-frame path in place of JPEG."""
    from tiatoolbox_tpu_torch.data import synth

    h, w = image.shape[:2]
    tiles = []
    for fy in range(-(-h // frame)):
        for fx in range(-(-w // frame)):
            tile = np.zeros((frame, frame, 3), np.uint8)
            block = image[fy * frame : (fy + 1) * frame, fx * frame : (fx + 1) * frame]
            tile[: block.shape[0], : block.shape[1]] = block
            tiles.append(tile)
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        frames = iter(list(pool.map(lambda t: native.encode_j2k(t, n_threads=1), tiles)))
    jpeg_encoder = synth.native.encode_jpeg
    synth.native.encode_jpeg = lambda tile, quality: next(frames)
    try:
        make_synthetic_dicom(path, frame_size=frame, mpp=0.5, image=image, compression="jpeg")
    finally:
        synth.native.encode_jpeg = jpeg_encoder
    data = path.read_bytes()
    check(data.count(b"1.2.840.10008.1.2.4.50") == 1, "one transfer syntax to replace")
    path.write_bytes(data.replace(b"1.2.840.10008.1.2.4.50", b"1.2.840.10008.1.2.4.90"))
    return path


def phase_jp2(tmp: Path, card: str) -> None:
    """JPEG 2000 on the port's own codec: the golden set, the JPEG phase's
    level-0 pixels (top-left 4096^2) written losslessly as a tiled JP2, an
    Aperio 33005 tiled TIFF and a .90 DICOM, each read back bit for bit,
    decode rates, then PatchPredictor over the JP2 and the TIFF with one
    mask and one SemanticSegmentor region-feed run over a JP2/TIFF pair."""
    t0 = time.perf_counter()
    golden = check_j2k_golden()
    root = tmp / "jp2"
    root.mkdir()
    base = KEPT.pop("jp2_pixels")
    wh = (base.shape[1], base.shape[0])
    half = imresize(base, scale_factor=0.5, interpolation="area")
    n_threads = os.cpu_count() or 1

    t = time.perf_counter()
    stream = encode_tiled_j2k(base, JP2_TILE)
    encode_s = time.perf_counter() - t
    jp2_path = root / "slide.jp2"
    jp2_path.write_bytes(jp2_container(stream, mpp=(0.5, 0.5)))
    t = time.perf_counter()
    tiff_path = root / "j2k.tiff"
    J2kTiffWriter(
        tiff_path, tile_size=JP2_TILE, description=aperio_description(wh, "J2K/RGB"), mpp=(0.5, 0.5),
        compression="deflate",
    ).write([base, half])
    retag_compression(tiff_path, tiffio.COMPRESSION_APERIO_J2K_RGB)
    dcm_path = j2k_dicom(root / "j2k.dcm", base, JP2_TILE)
    write_s = time.perf_counter() - t

    # decode rates: the JP2's level-0 tiles on one thread and on every worker
    info = native.j2k_header(stream)
    n_tiles = info["tiles_across"] * info["tiles_down"]
    native.decode_j2k_tiles(stream, range(4), n_threads=1)  # warm: pages, library
    t = time.perf_counter()
    one = native.decode_j2k_tiles(stream, range(JP2_ONE_THREAD_TILES), n_threads=1)
    one_s = time.perf_counter() - t
    many_s = []
    for _ in range(2):
        t = time.perf_counter()
        many = native.decode_j2k_tiles(stream, range(n_tiles), n_threads=n_threads)
        many_s.append(time.perf_counter() - t)
    check(all(np.array_equal(a, b) for a, b in zip(one, many)), "1-thread and n-thread tile decodes differ")
    tile_mpix = JP2_TILE * JP2_TILE / 1e6

    readers = {
        "jp2": (WSIReader.open(jp2_path), JP2WSIReader),
        "tiff_33005": (WSIReader.open(tiff_path), TIFFWSIReader),
        "dicom_90": (WSIReader.open(dcm_path), DICOMWSIReader),
    }
    mpix = wh[0] * wh[1] / 1e6
    read_rates = {}
    for name, (reader, cls) in readers.items():
        check(isinstance(reader, cls), f"{name} opened as {type(reader).__name__}")
        check(tuple(reader.info.slide_dimensions) == wh, f"{name} dimensions {reader.info.slide_dimensions}")
        got, sec = timed_read(reader, wh)
        check(got.shape == base.shape and np.array_equal(got, base), f"{name} level 0 is not the source, bit for bit")
        read_rates[name] = mpix / sec
    check(readers["jp2"][0]._codestream is not None, "the JP2 is read through its tiles")

    # PatchPredictor over the JP2 and the TIFF holding the same level 0, one
    # tissue mask for both (the JP2's virtual pyramid is not the TIFF's levels)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ioconfig = IOPatchPredictorConfig(**PRETRAINED_MODELS["resnet18-kather100k"]["ioconfig"]["kwargs"])
    mask = readers["tiff_33005"][0].tissue_mask()
    model = CNNModel("resnet18", num_classes=9, seed=0)
    corners = [((i // 4) * PATCH, (i % 4) * PATCH) for i in range(8)]
    calibrate_batch_norm(model, np.stack([base[y : y + PATCH, x : x + PATCH] for y, x in corners]))
    runs = {name: predictor_run(model, path, ioconfig, mask) for name, path in (("tiff_33005", tiff_path), ("jp2", jp2_path))}
    want, got = runs["tiff_33005"][0], runs["jp2"][0]
    n = len(want["probabilities"])
    check(n > 0, "the predictor kept patches")
    check(np.array_equal(got["coordinates"], want["coordinates"]), "jp2 patch coordinates")
    check(np.array_equal(got["predictions"], want["predictions"]), "jp2 predictions")
    prob_err = float(np.abs(got["probabilities"] - want["probabilities"]).max())
    check(prob_err <= 1e-6, f"jp2 probabilities differ by {prob_err}")
    release(model)

    # one SemanticSegmentor region-feed run over a JP2 and a TIFF holding the
    # same 2048x4096 pixels at 0.25 mpp: K4, K2 and K3 on the card, bit for bit
    crop = np.ascontiguousarray(base[: JP2_SEG_WH[1], : JP2_SEG_WH[0]])
    seg_jp2 = root / "seg.jp2"
    seg_jp2.write_bytes(jp2_container(encode_tiled_j2k(crop, JP2_TILE), mpp=(0.25, 0.25)))
    seg_tiff = root / "seg.tiff"
    tiffio.TiffPyramidWriter(seg_tiff, tile_size=JP2_TILE, mpp=(0.25, 0.25), compression="deflate").write([crop])
    # phase C's U-Net (the spill phase released C's): seeded and tempered again
    seg_model, seg_io = get_pretrained_model(SEG_MODEL, device=DEVICE)
    temper_random_weights(seg_model)
    seg = {}
    for name, path in (("tiff", seg_tiff), ("jp2", seg_jp2)):
        segmentor = SemanticSegmentor(seg_model, batch_size=SEG_BATCH, verbose=False)
        reset_segment_counts()
        t = time.perf_counter()
        out = segmentor.run([path], patch_mode=False, ioconfig=seg_io, auto_get_mask=False)[str(path)]
        torch.cuda.synchronize()
        counts = segment_counts()
        seg[name] = (out, counts, time.perf_counter() - t)
        check(segmentor.last_stage_summary["path"] == "device-canvas+region-feed", f"{name} segmentor path")
        check(all(v > 0 for v in counts.values()), f"{name} segmentor launches {counts}")
    a, b = seg["tiff"][0], seg["jp2"][0]
    check(a["probabilities"].shape == (*crop.shape[:2], 5), f"segment map {a['probabilities'].shape}")
    check(np.array_equal(a["probabilities"], b["probabilities"]), "segmentor maps over the JP2 and the TIFF differ")
    check(np.array_equal(a["predictions"], b["predictions"]), "segmentor predictions differ")
    seconds = time.perf_counter() - t0
    emit(
        {
            "phase": "jp2",
            "seconds": seconds,
            "golden": golden,
            "level0_mpix": mpix,
            "encode_mpix_per_s_n_threads": mpix / encode_s,
            "write_tiff_and_dicom_seconds": write_s,
            "codestream_bytes": len(stream),
            "tiles": n_tiles,
            "decode_mpix_per_s_1_thread": JP2_ONE_THREAD_TILES * tile_mpix / one_s,
            "decode_mpix_per_s_n_threads": [n_tiles * tile_mpix / x for x in many_s],
            "n_threads": n_threads,
            "read_level0_mpix_per_s": read_rates,
            "predict_patches": n,
            "predict_seconds": {k: v[1] for k, v in runs.items()},
            "prob_max_abs_diff": prob_err,
            "segment_launches": {k: v[1] for k, v in seg.items()},
            "segment_seconds": {k: v[2] for k, v in seg.items()},
            "card": card,
        }
    )
    check(seconds <= JP2_PHASE_LIMIT_S, f"the jp2 phase took {seconds:.1f} s")
    shutil.rmtree(root)


# -- Segment Anything: SAM and PromptSegmentor at ViT-B width -----------------

SAM_SEED = 0
# (baseline location, baseline area): a 1024^2 tile read at baseline, and an
# area larger than calc_mpp's 1500 px, read at 0.5 * 1.6 mpp as 1500x1000
SAM_TILES = {"square": ((1024, 1024), (1024, 1024)), "wide": ((512, 768), (2400, 1600))}
# per tile, in the tile's pixels: two points, one box, a point and a box
SAM_PROMPTS = {
    "square": {
        "points": {"point_coords": np.array([[[300, 420], [610, 380]]])},
        "box": {"box_coords": np.array([[[200, 150, 700, 640]]])},
        "point_box": {"point_coords": np.array([[[512, 512]]]), "box_coords": np.array([[[380, 360, 760, 700]]])},
    },
    "wide": {
        "points": {"point_coords": np.array([[[400, 300], [1100, 620]]])},
        "box": {"box_coords": np.array([[[250, 180, 1200, 860]]])},
        "point_box": {"point_coords": np.array([[[750, 500]]]), "box_coords": np.array([[[520, 260, 1010, 770]]])},
    },
}
SAM_CPU_TILE = "wide"  # the tile whose run with a point and a box is held against the CPU
SAM_CPU_KINDS = ("point_box",)  # both prompt encoders in one run
SAM_PIXEL_AGREEMENT = 0.999  # share of output mask pixels, card against the CPU
SAM_LOGIT_TOL = 1e-3  # low-resolution logits and IoU scores, card against the CPU, absolute
SAM_ENCODER_REPS = 10
SAM_BATCH = 4
SAM_PHASE_LIMIT_S = 120.0  # twice the phase's budget


class KeepingSAM(SAM):
    """SAM keeping its last call's low-resolution logits and masks."""

    def infer_logits(self, *args, **kwargs) -> list[dict]:
        self.kept_logits = super().infer_logits(*args, **kwargs)
        return self.kept_logits

    def infer_batch(self, *args, **kwargs) -> list[np.ndarray]:
        self.kept_masks = super().infer_batch(*args, **kwargs)
        return self.kept_masks


def sam_encoder_gflop(config: SamConfig) -> float:
    """GFLOP of one image through the image encoder (2 per multiply-add):
    patch embedding, each layer's linears over the token grid, attention
    over windows padded to a multiple of the window (global layers: the
    whole grid), and the neck."""
    v = config.vision_config
    grid, width = v.grid, v.hidden_size
    tokens = grid * grid
    macs = tokens * width * v.num_channels * v.patch_size**2
    for i in range(v.num_hidden_layers):
        macs += tokens * (4 * width * width + 2 * width * v.mlp_dim)
        window = grid if i in v.global_attn_indexes else v.window_size
        padded = -(-grid // window) * window
        macs += 2 * padded * padded * window * window * width  # q k^T and attn . v
    macs += tokens * (width * v.output_channels + 9 * v.output_channels**2)
    return 2 * macs / 1e9


def sam_tiles(slide: Path, engine: PromptSegmentor) -> dict:
    """Each SAM_TILES area read at the mpp calc_mpp gives, with its scale."""
    reader = WSIReader.open(slide)
    base_mpp = float(reader.info.mpp[0])
    tiles = {}
    for name, (location, area) in SAM_TILES.items():
        mpp, scale = engine.calc_mpp(area, base_mpp)
        size = (round(area[0] / scale), round(area[1] / scale))
        image = reader.read_rect(location, size, resolution=mpp, units="mpp")
        check(image.shape == (size[1], size[0], 3), f"sam tile {name} read as {image.shape}")
        tiles[name] = {"image": image, "location": location, "scale": scale, "mpp": mpp}
    return tiles


def sam_run(engine: PromptSegmentor, tile: dict, prompts: dict, out: Path, device: str) -> dict:
    """One PromptSegmentor.run over a tile; its store, masks and logits."""
    engine.scale = tile["scale"]
    engine.offset = np.array(tile["location"])
    t = time.perf_counter()
    paths = engine.run([tile["image"]], save_dir=out, device=device, **prompts)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    masks = engine.model.kept_masks[0]
    logits = engine.model.kept_logits[0]
    check(masks.shape == (3, *tile["image"].shape[:2]) and masks.dtype == bool, f"sam masks {masks.shape} {masks.dtype}")
    check(bool(torch.isfinite(logits["low_res_masks"]).all()), "sam logits are not finite")
    return {
        "seconds": seconds,
        "masks": masks,
        "logits": logits,
        "annotations": len(SQLiteStore(paths[0])),
        "foreground": float(masks.any(axis=0).mean()),
    }


def phase_sam(slide: Path, tmp: Path, card: str) -> None:
    """SAM at full ViT-B width from a checkpoint directory the script writes,
    PromptSegmentor.run on two tiles with three prompt kinds on the card,
    one tile's runs held against the CPU, and the network's times."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    root = tmp / "sam"
    config = SamConfig()
    t = time.perf_counter()
    state = seeded_sam_state(config, seed=SAM_SEED)
    save_sam_checkpoint(root / "checkpoint", state, config)
    write_s = time.perf_counter() - t
    checkpoint_bytes = disk_bytes(root / "checkpoint")
    t = time.perf_counter()
    sam = KeepingSAM(root / "checkpoint", device=DEVICE)
    load_s = time.perf_counter() - t
    loaded = sam.model.state_dict()
    check(len(loaded) == len(state), f"{len(loaded)} state-dict names, {len(state)} written")
    check(all(np.array_equal(loaded[k].cpu().numpy(), v) for k, v in state.items()), "the checkpoint did not load as written")
    del state, loaded
    engine = PromptSegmentor(model=sam)
    tiles = sam_tiles(slide, engine)

    reset_all_counts()
    stain_transform.launches = stain_augment.launches = 0
    runs = {}
    for name, tile in tiles.items():
        for kind, prompts in SAM_PROMPTS[name].items():
            runs[name, kind] = sam_run(engine, tile, prompts, root / f"{name}_{kind}", DEVICE)
    counts = {**all_counts(), "stain_transform": stain_transform.launches, "stain_augment": stain_augment.launches}
    check(any(r["annotations"] for r in runs.values()), "no SAM run gave an annotation")

    # the CPU on the same checkpoint, the same tile and prompts
    cpu_engine = PromptSegmentor(model=KeepingSAM(root / "checkpoint", device="cpu"))
    held = {}
    for kind in SAM_CPU_KINDS:
        prompts = SAM_PROMPTS[SAM_CPU_TILE][kind]
        card_run = runs[SAM_CPU_TILE, kind]
        cpu_run = sam_run(cpu_engine, tiles[SAM_CPU_TILE], prompts, root / f"cpu_{kind}", "cpu")
        logit_err = float((card_run["logits"]["low_res_masks"].cpu() - cpu_run["logits"]["low_res_masks"]).abs().max())
        iou_err = float((card_run["logits"]["iou_scores"].cpu() - cpu_run["logits"]["iou_scores"]).abs().max())
        agree = float((card_run["masks"] == cpu_run["masks"]).mean())
        held[kind] = {
            "logit_max_abs_diff": logit_err,
            "iou_max_abs_diff": iou_err,
            "pixel_agreement": agree,
            "annotations": [card_run["annotations"], cpu_run["annotations"]],
            "cpu_seconds": cpu_run["seconds"],
        }
        check(logit_err <= SAM_LOGIT_TOL and iou_err <= SAM_LOGIT_TOL, f"sam {kind}: logits {logit_err}, IoU {iou_err}")
        check(agree >= SAM_PIXEL_AGREEMENT, f"sam {kind}: {agree} of the mask pixels agree with the CPU")
        check(card_run["annotations"] == cpu_run["annotations"], f"sam {kind}: annotation counts {held[kind]['annotations']}")
    del cpu_engine

    # times: the encoder per image and at batch SAM_BATCH, the prompt encoder
    # and mask decoder per prompt, post-processing of the wide tile's masks
    cfg = sam.preprocessor
    pre_ms = time_ms(lambda: preprocess(tiles["wide"]["image"], cfg, DEVICE), SAM_ENCODER_REPS)
    pixels, _, _ = preprocess(tiles["square"]["image"], cfg, DEVICE)
    pixels = pixels[None]
    with torch.inference_mode():
        encoder_ms = time_ms(lambda: sam.model.vision_encoder(pixels), SAM_ENCODER_REPS)
        embedding = sam.model.vision_encoder(pixels)
        decoder_ms = {}
        for kind, prompts in SAM_PROMPTS["square"].items():
            tensors = sam.prompt_tensors(
                prompts.get("point_coords", [None])[0], prompts.get("box_coords", [None])[0], (1024, 1024)
            )
            decoder_ms[kind] = time_ms(lambda: sam.model(image_embeddings=embedding, **tensors), SAM_ENCODER_REPS)
        wide = runs["wide", "point_box"]["logits"]
        post_ms = time_ms(
            lambda: post_process_masks(wide["low_res_masks"], wide["original_size"], wide["reshaped_size"], cfg),
            SAM_ENCODER_REPS,
        )
        batch = pixels.repeat(SAM_BATCH, 1, 1, 1)
        torch.cuda.reset_peak_memory_stats()
        batch_ms = time_ms(lambda: sam.model.vision_encoder(batch), SAM_ENCODER_REPS // 2)
        peak = torch.cuda.max_memory_allocated()
    gflop = sam_encoder_gflop(config)
    seconds = time.perf_counter() - t0
    emit(
        {
            "phase": "sam",
            "seconds": seconds,
            "checkpoint_write_seconds": write_s,
            "checkpoint_bytes": checkpoint_bytes,
            "checkpoint_load_seconds": load_s,
            "tiles": {k: {"shape": list(v["image"].shape), "mpp": v["mpp"], "scale": v["scale"]} for k, v in tiles.items()},
            "runs": {
                f"{name}/{kind}": {k: r[k] for k in ("seconds", "annotations", "foreground")}
                for (name, kind), r in runs.items()
            },
            "kernel_launches": counts,
            "held_against_cpu": {"tile": SAM_CPU_TILE, **held},
            "preprocess_ms": pre_ms,
            "encoder_ms_per_image": encoder_ms,
            "encoder_gflop_per_image": gflop,
            "encoder_tflop_per_s": gflop / encoder_ms,
            f"encoder_images_per_s_batch_{SAM_BATCH}": SAM_BATCH * 1e3 / batch_ms,
            "decoder_ms_per_prompt": decoder_ms,
            "post_process_ms": post_ms,
            f"peak_bytes_batch_{SAM_BATCH}": peak,
            "card": card,
        }
    )
    check(seconds <= SAM_PHASE_LIMIT_S, f"the sam phase took {seconds:.1f} s")
    release(sam.model)
    shutil.rmtree(root)
    KEPT["sam"] = engine  # the serve phase's prompt segmentor


# -- whole-slide registration ---------------------------------------------------

REG_MPP = 1.0  # phase A/B's 0.5 mpp slide read at half resolution: 2048x1536
REG_ANGLE = 33.0  # degrees: the moving slide's known rotation about its centre
REG_SHIFT = (48.0, -36.0)  # px: and its known shift
REG_ROTATION_STEP = 10  # prealignment's search step (its default)
REG_GRID_SPACE = 50.0  # px between B-spline control points: 42 x 32 controls
REG_STEPS = 200
REG_CPU_STEPS = 10  # steps held against the CPU
REG_FIELD_TOL = 1e-3  # px, card against the CPU after REG_CPU_STEPS steps
REG_FEATURE_TOL = 1e-4  # VGG16 features, card against the CPU, of their largest |feature|
REG_VGG_REPS = 20
REG_PHASE_LIMIT_S = 90.0  # twice the phase's budget


def angle_of(transform: np.ndarray) -> float:
    """The rotation of a 3x3 affine, in degrees."""
    return float(np.degrees(np.arctan2(transform[1, 0], transform[0, 0])))


def masked_mse(image: np.ndarray, reference: np.ndarray, mask: np.ndarray) -> float:
    """Mean squared greyscale difference over ``mask``, on [0, 1]."""
    a = rgb2gray_u8(image).astype(np.float64) / 255
    b = rgb2gray_u8(reference).astype(np.float64) / 255
    return float(((a - b) ** 2)[mask].mean())


def composed_field(transform: np.ndarray, field: np.ndarray) -> np.ndarray:
    """The fixed -> moving-slide displacement of an affine (moving -> fixed)
    followed by a B-spline field on the affinely aligned image."""
    h, w = field.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    qx, qy = xs + field[..., 0], ys + field[..., 1]
    inv = np.linalg.inv(transform)
    mx = inv[0, 0] * qx + inv[0, 1] * qy + inv[0, 2]
    my = inv[1, 0] * qx + inv[1, 1] * qy + inv[1, 2]
    return np.stack([mx - xs, my - ys], axis=-1).astype(np.float32)


def rotation_about(centre: tuple[float, float], angle: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(centre, angle, 1.0)``: a counter-clockwise
    rotation by ``angle`` degrees about ``centre``."""
    a, b = np.cos(np.radians(angle)), np.sin(np.radians(angle))
    cx, cy = centre
    return np.array([[a, b, (1 - a) * cx - b * cy], [-b, a, b * cx + (1 - a) * cy]])


def tissue_section(image: np.ndarray) -> np.ndarray:
    """``image`` inside a section's outline (an ellipse and an off-centre
    lobe, so no rotation maps it onto itself), white glass outside: the
    synthetic slide is tissue from edge to edge, which gives a rotation
    search by mask overlap nothing to find."""
    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    body = ((xs - 0.45 * w) / (0.3 * w)) ** 2 + ((ys - 0.52 * h) / (0.36 * h)) ** 2 <= 1
    lobe = (xs - 0.72 * w) ** 2 + (ys - 0.3 * h) ** 2 <= (0.16 * h) ** 2
    out = np.full_like(image, 255)
    inside = body | lobe
    out[inside] = image[inside]
    return out


def phase_registration(slide: Path, tmp: Path, card: str) -> None:
    """Whole-slide registration of a pair made from phase A/B's slide (at
    half resolution, cut to a section's outline): the moving slide is the
    fixed one rotated and shifted by a known amount and written as a TIFF; prealignment, DFBR (VGG16 on the card) and the
    B-spline optimisation on the card, then reads of the moving slide
    through the affine and through the composed field."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_all_counts()
    stain_transform.launches = stain_augment.launches = 0
    t0 = time.perf_counter()
    root = tmp / "registration"
    root.mkdir()
    fixed = tissue_section(WSIReader.open(slide).read_bounds((0, 0, *SLIDE_WH), resolution=REG_MPP, units="mpp"))
    h, w = fixed.shape[:2]
    check((w, h) == (SLIDE_WH[0] // 2, SLIDE_WH[1] // 2), f"registration pair read as {fixed.shape}")
    truth = np.eye(3)
    truth[:2] = rotation_about((w / 2, h / 2), REG_ANGLE)
    truth[:2, 2] += REG_SHIFT
    moving = warp_affine(fixed, truth[:2], (w, h), border_value=255)
    moving_path = root / "moving.tiff"
    tiffio.TiffPyramidWriter(moving_path, tile_size=READER_TILE, mpp=(REG_MPP, REG_MPP), compression="deflate").write([moving])
    fixed_mask = OtsuTissueMasker().fit_transform(fixed[None])[0]
    moving_mask = OtsuTissueMasker().fit_transform(moving[None])[0]

    t = time.perf_counter()
    pre, pre_moving, _, pre_dice = prealignment(fixed, moving, fixed_mask, moving_mask, rotation_step=REG_ROTATION_STEP)
    pre_s = time.perf_counter() - t
    true_angle = angle_of(np.linalg.inv(truth))
    angle_error = (angle_of(pre) - true_angle + 180) % 360 - 180
    check(abs(angle_error) <= REG_ROTATION_STEP, f"prealignment rotation {angle_of(pre):.1f}, truth {true_angle:.1f}")

    dfbr = DFBRegister(device=DEVICE)
    t = time.perf_counter()
    affine = dfbr.register(fixed, moving, fixed_mask, moving_mask, transform_initializer=pre)
    if DEVICE != "cpu":
        torch.cuda.synchronize()
    dfbr_s = time.perf_counter() - t
    check(bool(np.isfinite(affine).all()), "DFBR transform is not finite")
    patch = resize_linear(fixed, (PATCH, PATCH))
    cpu_feats = DFBRFeatureExtractor(device="cpu")(patch)
    card_feats = dfbr._extractor(patch)
    feature_err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(card_feats, cpu_feats))
    check(feature_err <= REG_FEATURE_TOL, f"VGG16 features differ from the CPU by {feature_err}")
    x = torch.from_numpy(patch).to(DEVICE).permute(2, 0, 1)[None].float() / 255
    with torch.inference_mode():
        vgg_ms = time_ms(lambda: dfbr._extractor.model(x), REG_VGG_REPS)

    aligned = apply_affine_transformation(fixed, moving, affine)
    aligned_mask = apply_affine_transformation(fixed, moving_mask.astype(np.uint8), affine)
    bspline = {"fixed_image": fixed, "moving_image": aligned, "fixed_mask": fixed_mask, "moving_mask": aligned_mask,
               "grid_space": REG_GRID_SPACE}
    card_head = estimate_bspline_transform(**bspline, n_iterations=REG_CPU_STEPS, device=DEVICE)
    cpu_head = estimate_bspline_transform(**bspline, n_iterations=REG_CPU_STEPS, device="cpu")
    field_err = float(np.abs(card_head - cpu_head).max())
    check(field_err <= REG_FIELD_TOL, f"{REG_CPU_STEPS} B-spline steps differ from the CPU by {field_err} px")
    t = time.perf_counter()
    estimate_bspline_transform(**bspline, n_iterations=0, device=DEVICE)
    setup_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    field = estimate_bspline_transform(**bspline, n_iterations=REG_STEPS, device=DEVICE)
    bspline_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    check(field.shape == (h, w, 2) and bool(np.isfinite(field).all()), f"B-spline field {field.shape}")

    # reads of the moving slide in the fixed frame
    plain = WSIReader.open(moving_path)
    identity = TransformedWSIReader(moving_path, np.eye(3))
    check(
        np.array_equal(identity.read_rect((300, 200), (1024, 768)), plain.read_rect((300, 200), (1024, 768))),
        "an identity read differs from the plain read",
    )
    reads = {}
    for name, transform in (("affine", affine), ("field", composed_field(affine, field))):
        reader = TransformedWSIReader(moving_path, transform, fixed_info=plain.info)
        t = time.perf_counter()
        region = reader.read_rect((0, 0), (w, h))
        seconds = time.perf_counter() - t
        check(region.shape == fixed.shape, f"{name} read {region.shape}")
        reads[name] = {"seconds": seconds, "mpix_per_s": w * h / 1e6 / seconds, "mse": masked_mse(region, fixed, fixed_mask)}
    mse = {"moving": masked_mse(moving, fixed, fixed_mask), "prealigned": masked_mse(pre_moving, fixed, fixed_mask)}
    check(mse["prealigned"] < mse["moving"], f"prealignment did not bring the pair closer: {mse}")
    check(reads["field"]["mse"] < reads["affine"]["mse"], f"the B-spline field did not bring the pair closer: {reads}")
    seconds = time.perf_counter() - t0
    emit(
        {
            "phase": "registration",
            "seconds": seconds,
            "pair": [w, h],
            "truth": {"angle": REG_ANGLE, "shift": list(REG_SHIFT)},
            "prealignment": {"seconds": pre_s, "angle": angle_of(pre), "angle_error": angle_error, "dice": pre_dice},
            "dfbr": {"seconds": dfbr_s, "angle": angle_of(affine), "vgg16_ms_224": vgg_ms,
                     "features_rel_diff_cpu": feature_err},
            "bspline": {
                "controls": [int(np.ceil(h / REG_GRID_SPACE)) + 1, int(np.ceil(w / REG_GRID_SPACE)) + 1],
                "steps": REG_STEPS,
                "seconds": bspline_s,
                "setup_seconds": setup_s,
                "ms_per_step": (bspline_s - setup_s) * 1e3 / REG_STEPS,
                f"field_max_abs_diff_cpu_{REG_CPU_STEPS}_steps": field_err,
                "max_displacement": float(np.abs(field).max()),
                "peak_bytes": peak,
            },
            "reads": reads,
            "mse": mse,
            "kernel_launches": {**all_counts(), "stain_transform": stain_transform.launches,
                                "stain_augment": stain_augment.launches},
            "card": card,
        }
    )
    check(seconds <= REG_PHASE_LIMIT_S, f"the registration phase took {seconds:.1f} s")
    shutil.rmtree(root)


# -- rendering and tiles, the slide graph ---------------------------------------

RENDER_ALPHA = 0.5
RENDER_REGION = 2048  # D's store over D's slide: one 2048^2 read at baseline
RENDER_TILE = 256
D_PYRAMID_LEVELS = 5  # 4096x3072 in tiles of 256^2: 16 x 12, 8 x 6, 4 x 3, 2 x 2, 1
D_PYRAMID_TILES = 257
RENDER_READBACK = ((4, 8, 6), (3, 4, 3), (2, 1, 1), (0, 0, 0))  # (level, x, y) read back from the zip
RENDER_JPEG_PSNR_FLOOR_DB = 25.0  # a Q 95 tile of flat colours, thin edges and chroma subsampling
C_BASELINE_BLOCK = 4  # a 4 x 4 block of C's baseline tiles at the slide's centre
THUMB_DOWNSAMPLE = 16  # C's thumbnail-scale prediction: 384 x 288
GRAPH_THUMB_DOWNSAMPLE = 8  # phase A/B's slide: 512 x 384


class CountingRenderer(AnnotationRenderer):
    """The default renderer, counting the geometries it draws."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.drawn = 0

    def _draw_geometry(self, canvas, geom, origin, sf, color) -> None:
        self.drawn += 1
        super()._draw_geometry(canvas, geom, origin, sf, color)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def phase_render(tmp: Path, card: str) -> None:
    """Stores as slides and tile pyramids, drawn by the port's host rasteriser."""
    kept = KEPT["render"]  # the serve phase takes it after
    t_start = time.perf_counter()
    line: dict = {"phase": "render"}

    t0 = time.perf_counter()
    line["golden"] = {"arrays": check_raster_golden(), "seconds": time.perf_counter() - t0}

    # D's store over D's slide, through WSIReader.open
    t0 = time.perf_counter()
    reader = WSIReader.open(kept["D_store"], base_wsi=kept["D_slide"], alpha=RENDER_ALPHA)
    check(isinstance(reader, AnnotationStoreReader), f"WSIReader.open(.db) gave {type(reader).__name__}")
    check(tuple(reader.info.slide_dimensions) == INST_SLIDE_WH, f"store reader dims {reader.info.slide_dimensions}")
    open_seconds = time.perf_counter() - t0
    x0, y0 = (INST_SLIDE_WH[0] - RENDER_REGION) // 2, (INST_SLIDE_WH[1] - RENDER_REGION) // 2
    t0 = time.perf_counter()
    region = reader.read_rect((x0, y0), (RENDER_REGION, RENDER_REGION))
    region_seconds = time.perf_counter() - t0
    base = WSIReader.open(kept["D_slide"]).read_rect((x0, y0), (RENDER_REGION, RENDER_REGION))
    check(region.shape == base.shape == (RENDER_REGION, RENDER_REGION, 3) and region.dtype == np.uint8,
          f"region {region.shape} {region.dtype}")
    tinted = float(np.any(region != base, axis=-1).mean())
    check(0.01 < tinted < 0.99, f"the overlay changes {tinted} of the region's pixels")
    t0 = time.perf_counter()
    thumb = reader.slide_thumbnail()
    thumb_seconds = time.perf_counter() - t0
    check(thumb.ndim == 3 and thumb.shape[2] == 3 and thumb.size > 0, f"thumbnail {thumb.shape}")
    line["store_reader"] = {
        "instances": kept["D_instances"], "open_seconds": open_seconds,
        "region": [RENDER_REGION, RENDER_REGION], "region_seconds": region_seconds,
        "region_mpix_per_s": RENDER_REGION**2 / 1e6 / region_seconds, "tinted_share": tinted,
        "thumbnail": list(thumb.shape), "thumbnail_seconds": thumb_seconds,
    }

    # D's annotation pyramid to a zip, tiles read back through the port's decoder
    renderer = CountingRenderer()
    gen = AnnotationTileGenerator(reader.info, reader.store, renderer=renderer, tile_size=RENDER_TILE)
    n_tiles = sum(int(np.prod(gen.tile_grid_size(level))) for level in range(gen.level_count))
    check(gen.level_count == D_PYRAMID_LEVELS and n_tiles == D_PYRAMID_TILES,
          f"D pyramid {gen.level_count} levels, {n_tiles} tiles")
    archive = tmp / "d_pyramid.zip"
    t0 = time.perf_counter()
    gen.dump(archive, container="zip")
    dump_seconds = time.perf_counter() - t0
    drawn = renderer.drawn
    readback = []
    with zipfile.ZipFile(archive) as zf:
        check(len(zf.namelist()) == D_PYRAMID_TILES, f"zip holds {len(zf.namelist())} tiles")
        for level, x, y in RENDER_READBACK:
            data = zf.read(str(gen.tile_path(level, x, y)))
            tile = gen.get_tile(level, x, y)
            check(data == native.encode_jpeg(tile[..., :3], 95), f"tile {level}/{x}_{y} is not the encoder's bytes")
            decoded = imdecode(data)
            check(decoded.shape == (RENDER_TILE, RENDER_TILE, 3), f"decoded tile {decoded.shape}")
            psnr = psnr_db(decoded, tile[..., :3])
            check(psnr >= RENDER_JPEG_PSNR_FLOOR_DB, f"tile {level}/{x}_{y} decodes at {psnr} dB")
            readback.append({"tile": [level, x, y], "bytes": len(data), "psnr_db": psnr,
                             "opaque_share": float((tile[..., 3] > 0).mean())})
    check(any(r["opaque_share"] > 0 for r in readback), "every read-back tile is empty")
    line["d_pyramid"] = {
        "levels": gen.level_count, "tiles": n_tiles, "seconds": dump_seconds,
        "tiles_per_s": n_tiles / dump_seconds, "mpix_per_s": n_tiles * RENDER_TILE**2 / 1e6 / dump_seconds,
        "geometries_drawn": drawn, "polygons_per_s": drawn / dump_seconds,
        "zip_bytes": archive.stat().st_size, "readback": readback,
    }

    # the reader without a base gives the generator's tile composited onto
    # white (one renderer for both: categorical colours go by first sight)
    bare = AnnotationStoreReader(kept["D_store"], info=reader.info, renderer=renderer)
    top = gen.level_count - 1
    for x, y in ((8, 6), (3, 2), (15, 11)):
        want = background_composite(gen.get_tile(top, x, y), alpha=False)
        got = bare.read_rect((x * RENDER_TILE, y * RENDER_TILE), (RENDER_TILE, RENDER_TILE))
        check(np.array_equal(got, want), f"store reader tile ({x}, {y}) differs from the generator's")

    # C's store: the coarsest level (decimated) and 16 baseline tiles
    c_reader = WSIReader.open(kept["C_slide"])
    c_store = SQLiteStore(kept["C_store"])
    c_renderer = CountingRenderer()
    c_gen = AnnotationTileGenerator(c_reader.info, c_store, renderer=c_renderer, tile_size=RENDER_TILE)
    coarse_scale = 2 ** (c_gen.level_count - 1)
    check(coarse_scale > c_renderer.max_scale, f"C's coarsest scale {coarse_scale} is not decimated")
    t0 = time.perf_counter()
    coarse = c_gen.get_tile(0, 0, 0)
    coarse_seconds = time.perf_counter() - t0
    coarse_drawn = c_renderer.drawn
    # decimated: only polygons of 0.05 % of the slide's square or more are drawn
    check(coarse.shape == (RENDER_TILE, RENDER_TILE, 4), f"C's coarsest tile {coarse.shape}")
    top = c_gen.level_count - 1
    gw, gh = c_gen.tile_grid_size(top)
    xs = range(gw // 2 - C_BASELINE_BLOCK // 2, gw // 2 + C_BASELINE_BLOCK // 2)
    ys = range(gh // 2 - C_BASELINE_BLOCK // 2, gh // 2 + C_BASELINE_BLOCK // 2)
    c_renderer.drawn = 0
    t0 = time.perf_counter()
    tiles = [c_gen.get_tile(top, x, y) for y in ys for x in xs]
    tiles_seconds = time.perf_counter() - t0
    check(len(tiles) == C_BASELINE_BLOCK**2 and any(t[..., 3].any() for t in tiles), "C's baseline tiles are empty")
    line["c_store"] = {
        "coarsest": {"scale": coarse_scale, "seconds": coarse_seconds, "geometries_drawn": coarse_drawn,
                     "opaque_share": float((coarse[..., 3] > 0).mean())},
        "baseline_tiles": {"tiles": len(tiles), "seconds": tiles_seconds, "tiles_per_s": len(tiles) / tiles_seconds,
                           "mpix_per_s": len(tiles) * RENDER_TILE**2 / 1e6 / tiles_seconds,
                           "geometries_drawn": c_renderer.drawn, "polygons_per_s": c_renderer.drawn / tiles_seconds},
    }

    # overlays on C's thumbnail-scale prediction
    w, h = c_reader.info.slide_dimensions
    t0 = time.perf_counter()
    c_thumb = c_reader.read_bounds((0, 0, w, h), resolution=1 / THUMB_DOWNSAMPLE, units="baseline")
    size = (c_thumb.shape[1], c_thumb.shape[0])
    pred = imresize(np.ascontiguousarray(kept["C_predictions"], np.uint8), output_size=size, interpolation="nearest")
    prob = imresize(np.ascontiguousarray(kept["C_probabilities"], np.float32), output_size=size, interpolation="nearest")
    mask_overlay = overlay_prediction_mask(c_thumb, pred, alpha=0.35)
    prob_overlay = overlay_probability_map(c_thumb, prob, alpha=0.35, min_val=0.1)
    overlay_seconds = time.perf_counter() - t0
    fg = pred > 0
    check(mask_overlay.shape == prob_overlay.shape == c_thumb.shape, f"overlays {mask_overlay.shape}")
    check(np.array_equal(mask_overlay[~fg], c_thumb[~fg]), "overlay_prediction_mask tinted class 0")
    check(not fg.any() or bool(np.any(mask_overlay[fg] != c_thumb[fg])), "overlay_prediction_mask tinted nothing")
    check(np.array_equal(prob_overlay[prob < 0.1], c_thumb[prob < 0.1]), "overlay_probability_map below min_val")
    line["overlays"] = {"thumbnail": list(c_thumb.shape), "seconds": overlay_seconds,
                        "foreground_share": float(fg.mean())}
    c_store.close()
    line["seconds"] = time.perf_counter() - t_start
    line["card"] = card
    emit(line)


def phase_graph(slide: Path, tmp: Path, card: str) -> None:
    """PatchPredictor over the Kather stand-in; the slide graph of the features
    phase's resnet50 features, coloured by UMAP and drawn on the thumbnail."""
    kept = KEPT.pop("features")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    line: dict = {"phase": "graph"}

    t0 = time.perf_counter()
    dataset = KatherPatchDataset(tmp / "kather100k")  # no such directory: the synthetic stand-in
    stand_in_seconds = time.perf_counter() - t0
    images = np.asarray(dataset.inputs)
    check(images.shape == (128, PATCH, PATCH, 3) and len(dataset.labels) == 128, f"stand-in {images.shape}")
    model = CNNModel("resnet18", num_classes=9, seed=0)
    calibrate_batch_norm(model, images[:BATCH])
    reset_all_counts()
    t0 = time.perf_counter()
    out = PatchPredictor(model=model, batch_size=BATCH, verbose=False).run(images, patch_mode=True)
    predict_seconds = time.perf_counter() - t0
    probs = out["probabilities"]
    check(probs.shape == (128, 9) and bool(np.isfinite(probs).all()), f"stand-in probabilities {probs.shape}")
    check(np.array_equal(out["predictions"], probs.argmax(axis=1)), "stand-in predictions")
    cpu_model = CNNModel("resnet18", num_classes=9, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_err = float(np.abs(CNNModel.infer_batch(cpu_model, images[:4]) - probs[:4]).max())
    check(cpu_err <= 1e-3, f"stand-in card vs CPU probabilities {cpu_err} > 1e-3")
    line["kather_stand_in"] = {
        "patches": len(images), "build_seconds": stand_in_seconds, "predict_seconds": predict_seconds,
        "patches_per_s": len(images) / predict_seconds, "cpu_max_abs_diff": cpu_err,
        "agreement_with_labels": float(np.mean(out["predictions"] == np.asarray(dataset.labels))),
        "launches": all_counts(),
    }
    del model, cpu_model
    torch.cuda.empty_cache()

    group = open_zarr(kept["path"])
    features, coords = group["features"][:], group["coordinates"][:]
    check(len(features) == PREDICT_PATCHES, f"{len(features)} feature rows, not {PREDICT_PATCHES}")
    points = (coords[:, :2] + coords[:, 2:]) / 2
    t0 = time.perf_counter()
    graph = SlideGraphConstructor.build(points, features)
    build_seconds = time.perf_counter() - t0
    n, edges = len(graph["x"]), graph["edge_index"]
    check(edges.ndim == 2 and edges.shape[0] == 2 and edges.shape[1] > 0, f"edge_index {edges.shape}")
    check(int(edges.max()) < n and graph["coordinates"].shape == (n, 2), "edges index the clusters")
    t0 = time.perf_counter()
    colours = SlideGraphConstructor._umap_reducer(graph)
    umap_seconds = time.perf_counter() - t0
    check(colours.shape == (n, 3) and bool(np.isfinite(colours).all()), f"UMAP colours {colours.shape}")
    check(float(colours.min()) >= 0 and float(colours.max()) <= 1, "UMAP colours outside [0, 1]")
    w, h = SLIDE_WH
    thumb = WSIReader.open(slide).read_bounds((0, 0, w, h), resolution=1 / GRAPH_THUMB_DOWNSAMPLE, units="baseline")
    canvas = np.ascontiguousarray(thumb.copy())
    t0 = time.perf_counter()
    plot_graph(canvas, graph["coordinates"][:, ::-1] / GRAPH_THUMB_DOWNSAMPLE, edges.T,
               node_colors=[tuple(int(v) for v in c) for c in (colours * 255).astype(np.uint8)],
               node_size=4, edge_size=1)
    plot_seconds = time.perf_counter() - t0
    check(bool(np.any(canvas != thumb)), "plot_graph drew nothing")
    t0 = time.perf_counter()
    golden = check_graph_golden()
    line["slide_graph"] = {
        "features": [int(d) for d in features.shape], "model": kept["model"], "clusters": n,
        "edges": int(edges.shape[1]), "build_seconds": build_seconds, "umap_seconds": umap_seconds,
        "plot_seconds": plot_seconds, "thumbnail": list(thumb.shape),
        "golden": {**golden, "seconds": time.perf_counter() - t0},
    }
    line["seconds"] = time.perf_counter() - t_start
    line["card"] = card
    emit(line)


# -- the tile server and the CLI ------------------------------------------------

SERVE_BOX = 1024  # segment_on_box over a 1024^2 box of D's slide (0.25 mpp, the model's)
SERVE_TILE_LEVELS = 3  # slide and D-store tiles at the three finest zoomify levels
SERVE_TILES_PER_LEVEL = 4
SERVE_PROMPT_BOX = 384  # SAM's prompt box, px, inside the segmented box
SERVE_CLI_LIMIT_S = 45.0  # the serve and cli phases together
CLI_PREDICT_TOL = 1e-5  # the CLI's probabilities against phase B's, same weights and batch


def http(url: str, method: str = "GET", params: dict | None = None, timeout: float = 600) -> tuple[str, bytes]:
    """(content type, body) of one request to the local server."""
    data = urllib.parse.urlencode(params).encode() if params is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.headers["Content-Type"], resp.read()


def http_json(url: str, method: str = "GET", params: dict | None = None) -> dict:
    kind, body = http(url, method, params)
    check(kind == "application/json", f"{url} answered {kind}")
    return json.loads(body)


def phase_serve(tmp: Path, card: str) -> float:
    """The port's TileServer on a thread over D's slide and store (the overlay): tiles, info,
    taps and control routes over HTTP, one segment_on_box with HoVer-Net at
    full width on the card held to a direct engine run of the same region,
    one SAM box prompt through the sam phase's seeded ViT-B, then shutdown."""
    kept = KEPT.pop("render")
    sam_engine = KEPT.pop("sam")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_all_counts()
    stain_transform.launches = stain_augment.launches = 0
    t_start = time.perf_counter()
    line: dict = {"phase": "serve"}
    home = tmp / "serve_home"
    (home / "models").mkdir(parents=True)
    torch.save(functional_hovernet_state_dict(), home / "models" / f"{INST_MODEL}.pth")
    old_home = rcParam["TIATOOLBOX_HOME"]
    rcParam["TIATOOLBOX_HOME"] = home
    server = TileServer(title="chip_smoke", layers={"slide": str(kept["D_slide"])}, prompt_segmentor=sam_engine)
    httpd, port = server.run_in_thread()
    url = f"http://127.0.0.1:{port}/tileserver"
    try:
        check(http_json(f"{url}/healthcheck") == {"status": "OK"}, "healthcheck")
        types = http_json(f"{url}/annotations", "PUT", {"file_path": str(kept["D_store"])})["types"]
        check(len(types) >= 1, f"D's store has types {types}")
        check(http_json(f"{url}/layers") == {"layers": ["slide", "overlay"]}, "layers")
        info = http_json(f"{url}/info/slide")
        check(info["slide_dimensions"] == list(INST_SLIDE_WH), f"info {info['slide_dimensions']}")
        check(http_json(f"{url}/info/overlay") == {"type": "annotation", "count": kept["D_instances"]}, "store info")

        # slide and store tiles at the three finest levels, each slide tile
        # byte for byte the encoder's bytes of the pyramid's own tile
        pyramid = server.pyramids["slide"]
        levels = list(range(pyramid.level_count - SERVE_TILE_LEVELS, pyramid.level_count))
        t0 = time.perf_counter()
        n_tiles = 0
        for level in levels:
            gw, gh = pyramid.tile_grid_size(level)
            for i in range(SERVE_TILES_PER_LEVEL):
                x, y = (gw // 2 + i) % gw, (gh // 2 + i // 2) % gh
                kind, body = http(f"{url}/layer/slide/default/zoomify/TileGroup0/{level}-{x}-{y}.jpg")
                check(kind == "image/jpeg", f"slide tile {level}-{x}-{y} is {kind}")
                check(body == native.encode_jpeg(pyramid.get_tile(level, x, y), 85), f"slide tile {level}-{x}-{y}")
                kind, body = http(f"{url}/layer/overlay/default/zoomify/TileGroup0/{level}-{x}-{y}.jpg")
                check(kind == "image/png" and imdecode(body, "unchanged").shape[2] == 4, f"D tile {level}-{x}-{y}")
                n_tiles += 2
        tile_seconds = time.perf_counter() - t0

        # a tap on an instance's centre, and the control routes the viewer uses
        first = next(iter(server.layers["overlay"].values()))
        cx, cy = np.asarray(first.geometry.shell, float).mean(axis=0)
        taps = http_json(f"{url}/tap_query/overlay/{cx}/{cy}")["annotations"]
        check(len(taps) >= 1, f"tap at ({cx:.1f}, {cy:.1f}) found nothing")
        check(http_json(f"{url}/color_prop", "PUT", {"prop": "type"}) == {"color_prop": "type"}, "color_prop")
        check(http_json(f"{url}/cmap", "PUT", {"cmap": "viridis"}) == {"cmap": "viridis"}, "cmap")
        check("type" in http_json(f"{url}/prop_names")["prop_names"], "prop_names")
        check(http_json(f"{url}/sessions") == {"sessions": {"default": str(kept["D_slide"])}}, "sessions")

        # segment_on_box on the card, then the same region through the engine directly
        x0, y0 = (INST_SLIDE_WH[0] - SERVE_BOX) // 2, (INST_SLIDE_WH[1] - SERVE_BOX) // 2
        box = {"x0": x0, "y0": y0, "x1": x0 + SERVE_BOX, "y1": y0 + SERVE_BOX}
        before = all_counts()
        t0 = time.perf_counter()
        seg = http_json(f"{url}/segment_on_box", "PUT", box)
        box_seconds = time.perf_counter() - t0
        box_counts = {name: n - before[name] for name, n in all_counts().items()}
        for name in ("scatter_accumulate", "hv_energy", "pack_fg_tp"):
            check(box_counts[name] > 0, f"segment_on_box launched no {name}: {box_counts}")
        check(seg["layer"] == "segment" and seg["count"] > 0, f"segment_on_box {seg}")
        model, ioconfig = get_pretrained_model(INST_MODEL)
        region = server.layers["slide"].read_bounds(tuple(box.values()), resolution=0.25, units="mpp")
        engine = MultiTaskSegmentor(model, batch_size=4, num_loader_workers=0, verbose=False)
        t0 = time.perf_counter()
        direct = next(iter(engine.run([region], patch_mode=False, ioconfig=region_ioconfig(ioconfig),
                                      auto_get_mask=False).values()))["instances"]
        direct_seconds = time.perf_counter() - t0
        direct_summary = dict(engine.last_stage_summary or {})

        def order(row):
            return (row[0], *row[1].min(axis=0), *row[1].max(axis=0), len(row[1]))

        want = sorted(((int(i["type"]), np.asarray(i["contours"], float) + [x0, y0])
                       for i in direct.values() if len(i["contours"]) >= 3), key=order)
        got = sorted(((a.properties["type"], np.asarray(a.geometry.shell, float)[:-1])
                      for a in server.layers["segment"].values()), key=order)
        check(len(got) == len(want) == seg["count"], f"segment layer {len(got)}, direct run {len(want)}")
        check(all(g[0] == w[0] and np.array_equal(g[1], w[1]) for g, w in zip(got, want)),
              "segment layer's contours differ from the direct run's")
        release(model)

        # one SAM box prompt through the sam phase's seeded ViT-B
        px, py = x0 + 200, y0 + 200
        t0 = time.perf_counter()
        prompt = http_json(f"{url}/prompt_segment", "PUT",
                           {"box": json.dumps([px, py, px + SERVE_PROMPT_BOX, py + SERVE_PROMPT_BOX])})
        prompt_seconds = time.perf_counter() - t0
        check(prompt["layer"] == "prompt" and prompt["count"] >= 0, f"prompt_segment {prompt}")
        bounds = [a.geometry.bounds for a in server.layers["prompt"].values()]
        check(all(px - 1 <= b[0] and b[2] <= px + SERVE_PROMPT_BOX + 1 for b in bounds), "prompt outside its box")
        kind, body = http(f"{url}/layer/segment/default/zoomify/TileGroup0/{levels[-1]}-"
                          f"{(x0 + SERVE_BOX // 2) // 256}-{(y0 + SERVE_BOX // 2) // 256}.jpg")
        check(kind == "image/png", "segment tile")
        stopped = http_json(f"{url}/shutdown", "PUT")
        check(stopped["servers"] == 1, f"shutdown {stopped}")
    finally:
        rcParam["TIATOOLBOX_HOME"] = old_home
        release(sam_engine.model.model)
    for _ in range(100):
        if not server._servers:  # noqa: SLF001 - the stopper thread has closed the socket
            break
        time.sleep(0.05)
    check(not server._servers, "the server is still listening after shutdown")  # noqa: SLF001
    line.update({
        "tiles": n_tiles, "tile_seconds": tile_seconds, "tiles_per_s": n_tiles / tile_seconds,
        "tile_levels": levels,
        "segment_on_box": {"box": [SERVE_BOX, SERVE_BOX], "seconds": box_seconds, "instances": seg["count"],
                           "types": seg["types"], "direct_run_seconds": direct_seconds, "launches": box_counts,
                           "direct_run_path": direct_summary.get("path"),
                           "direct_run_stages": {k: v for k, v in direct_summary.items() if isinstance(v, dict)}},
        "prompt_segment": {"box": [SERVE_PROMPT_BOX, SERVE_PROMPT_BOX], "seconds": prompt_seconds,
                           "annotations": prompt["count"]},
        "kernel_launches": {**all_counts(), "stain_transform": stain_transform.launches,
                            "stain_augment": stain_augment.launches},
        "seconds": time.perf_counter() - t_start,
        "card": card,
    })
    emit(line)
    return line["seconds"]


def cli(*args: str) -> str:
    """``main(args)`` in this process; its printed output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main([str(a) for a in args])
    check(code == 0, f"cli {args[0]} returned {code}")
    return out.getvalue()


def phase_cli(tmp: Path, card: str, serve_seconds: float) -> None:
    """The port's CLI in this process on phase A/B's slide: slide-info,
    slide-thumbnail, read-bounds, tissue-mask, save-tiles, stain-norm, then
    patch-predictor on the card with phase B's weights under
    TIATOOLBOX_HOME/models, held to phase B's predictions; and
    ``python -m tiatoolbox_tpu_torch.cli version`` in a subprocess. The
    serve phase (``serve_seconds``) and this one share one budget."""
    kept = KEPT.pop("cli")
    slide = kept["slide"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_all_counts()
    stain_transform.launches = stain_augment.launches = 0
    t_start = time.perf_counter()
    out = tmp / "cli"
    seconds: dict = {}

    def timed(name: str, *args) -> str:
        t0 = time.perf_counter()
        text = cli(name, *args)
        seconds[name] = time.perf_counter() - t0
        return text

    timed("slide-info", "--img-input", slide, "--mode", "save", "--output-path", out / "info")
    info = yaml_lite.load((out / "info" / f"{slide.stem}.yaml").read_text())
    check(info["slide_dimensions"] == str(tuple(SLIDE_WH)), f"slide-info {info['slide_dimensions']}")
    timed("slide-thumbnail", "--img-input", slide, "--output-path", out / "thumb")
    thumb = imread(out / "thumb" / f"{slide.stem}_thumb.png")
    check(thumb.shape == (SLIDE_WH[1] // 16, SLIDE_WH[0] // 16, 3), f"thumbnail {thumb.shape}")
    timed("read-bounds", "--img-input", slide, "--region", "1000,800,3000,2800", "--output-path", out / "region.jpg")
    check(imread(out / "region.jpg").shape == (2000, 2000, 3), "read-bounds")
    timed("tissue-mask", "--img-input", slide, "--output-path", out / "mask")
    mask = imread(out / "mask" / f"{slide.stem}_mask.png")
    check(mask.shape[:2] == thumb.shape[:2] and 0 < float((mask > 0).mean()) < 1, f"tissue mask {mask.shape}")
    timed("save-tiles", "--img-input", slide, "--output-path", out / "tiles", "--tile-objective-value", "10",
          "--tile-read-size", "1024", "768")
    tiles = sorted((out / "tiles" / slide.name).glob("Tile_*.jpg"))
    n_tiles = -(-SLIDE_WH[0] // 2 // 1024) * -(-SLIDE_WH[1] // 2 // 768)  # at 10x, half of the 20x slide
    check(len(tiles) == n_tiles and imread(tiles[0]).shape == (768, 1024, 3), f"save-tiles wrote {len(tiles)}")
    patch = out / "patch.png"
    imwrite(patch, WSIReader.open(slide).read_rect((1024, 1024), (512, 512)))
    timed("stain-norm", "--img-input", patch, "--method", "macenko", "--output-path", out / "stain")
    normed = imread(out / "stain" / "patch_normalized.png")
    check(normed.shape == (512, 512, 3) and float(np.abs(normed.astype(int) - imread(patch)).mean()) > 0, "stain-norm")

    # patch-predictor on the card with phase B's weights
    home = tmp / "cli_home"
    (home / "models").mkdir(parents=True)
    torch.save(kept["model"].state_dict(), home / "models" / "resnet18-kather100k.pth")
    old_home = rcParam["TIATOOLBOX_HOME"]
    rcParam["TIATOOLBOX_HOME"] = home
    try:
        timed("patch-predictor", "--img-input", slide, "--output-path", out / "pp", "--batch-size", BATCH,
              "--return-probabilities", "true", "--output-type", "zarr", "--quiet")
    finally:
        rcParam["TIATOOLBOX_HOME"] = old_home
    group = open_zarr(out / "pp" / "raw" / f"{slide.stem}.zarr")
    want = kept["result"]
    predictions, probs = group["predictions"][:], group["probabilities"][:]
    check(np.array_equal(group["coordinates"][:], want["coordinates"]), "patch-predictor coordinates")
    check(np.array_equal(predictions, want["predictions"]), "patch-predictor predictions differ from phase B's")
    prob_err = float(np.abs(probs - want["probabilities"]).max())
    check(prob_err <= CLI_PREDICT_TOL, f"patch-predictor probabilities {prob_err} from phase B's")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tiatoolbox_tpu_torch.cli", "version"], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True, text=True, timeout=120,
                          check=False)
    seconds["python -m ... version"] = time.perf_counter() - t0
    check(proc.returncode == 0 and proc.stdout.startswith("tiatoolbox-tpu-torch "), f"module entry: {proc.stderr[-300:]}")
    cli_seconds = time.perf_counter() - t_start
    line = {
        "phase": "cli", "seconds_per_command": seconds, "patches": int(len(predictions)),
        "probabilities_max_abs_diff": prob_err,
        "kernel_launches": {**all_counts(), "stain_transform": stain_transform.launches,
                            "stain_augment": stain_augment.launches},
        "seconds": cli_seconds, "serve_and_cli_seconds": serve_seconds + cli_seconds, "card": card,
    }
    emit(line)
    check(line["serve_and_cli_seconds"] <= SERVE_CLI_LIMIT_S,
          f"the serve and cli phases took {line['serve_and_cli_seconds']:.1f} s together")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run.", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    marks: dict[str, float] = {}

    def mark(name: str) -> None:
        marks[name] = time.perf_counter() - t_start

    card = phase_env()
    phase_build()
    mark("build")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        jpeg_slide = phase_jpeg(Path(tmp), card)
        phase_mask_extract(Path(tmp), card)
        phase_predict_jpeg(jpeg_slide, card)
        jpeg_slide.unlink()
        mark("jpeg_phases")
        # Peak allocated bytes depend on which cached blocks the allocator
        # reuses (a block is not split below 1 MiB of slack), so phases A-D
        # start from an emptied cache, as they did before the JPEG phases.
        torch.cuda.empty_cache()
        slide = phase_slide(Path(tmp))
        stain = phase_stain(slide)
        phase_predict(slide, card)
        mark("A_B")
        segment = phase_segment(Path(tmp), card)
        mark("C")
        instance, held = phase_instance(Path(tmp), card)
        mark("D")
        t_wire = time.perf_counter()
        wire = phase_wire(Path(tmp), card)
        wire_seconds = time.perf_counter() - t_wire
        mark("wire")
        dp_seconds = phase_dp(Path(tmp), card)
        mark("dp")
        check(wire_seconds + dp_seconds <= WIRE_DP_LIMIT_S,
              f"the wire and dp phases took {wire_seconds:.1f} + {dp_seconds:.1f} s, over {WIRE_DP_LIMIT_S} s")
        phase_outputs(Path(tmp), card)
        mark("outputs")
        phase_spill(Path(tmp), card)
        mark("spill")
        detect = phase_detect(slide, Path(tmp), card)
        mark("detect")
        zoo = phase_nucleus_zoo(slide, Path(tmp), card)
        mark("nucleus_zoo")
        phase_classifier_zoo(slide, card)
        mark("zoo")
        phase_features(slide, Path(tmp), card)
        mark("features")
        tail = phase_registry_tail(slide, Path(tmp), card)
        mark("registry_tail")
        augment = phase_stain_ext(slide)
        mark("stain_ext")
        phase_readers(slide, Path(tmp), card)
        mark("readers")
        phase_jp2(Path(tmp), card)
        mark("jp2")
        phase_sam(slide, Path(tmp), card)
        mark("sam")
        phase_registration(slide, Path(tmp), card)
        mark("registration")
        phase_render(Path(tmp), card)
        mark("render")
        phase_graph(slide, Path(tmp), card)
        mark("graph")
        serve_seconds = phase_serve(Path(tmp), card)
        mark("serve")
        phase_cli(Path(tmp), card, serve_seconds)
        mark("cli")
    # seconds since the start at the end of each group of phases
    emit({"phase": "timeline", "seconds_at_end": marks})
    # K2 to K4 run on phases C and D: their rows count both phases' launches
    # and the larger difference from the plain versions
    for row in segment:
        row["launches"] += held[row["name"]]["launches"]
        row["max_abs_err"] = max(row["max_abs_err"], held[row["name"]]["max_abs_err"])
    print(json.dumps({"kernels": [stain, *segment, *instance, *detect, *zoo, *tail, augment, *wire]}), flush=True)
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
