"""The port runs where only torch, numpy and scipy are installed.

A subprocess installs a ``sys.meta_path`` finder that refuses jax, flax,
cv2, yaml, PIL, pandas, tqdm, psutil and the JAX package, imports every
module of ``tiatoolbox_tpu_torch`` and ``chip_smoke``, and runs the slices
(stain transform, bench config 2's mask and sliding-window extraction,
whole-slide patch classification, whole-slide semantic segmentation and
whole-slide nucleus instance segmentation, which build and load the host
C++ libraries: the JPEG codec of the slide's tiles, the watershed) on the
CPU on a tiny JPEG slide, and saves the results in every output type (the
contour tracer's C++, sqlite3, the colour tables); then nucleus detection
with SCCNN and HoVer-Net+'s layer post-processing; then the classifier zoo
(MobileNetV3, an IDaRS entry) and feature extraction (DenseNet and
EfficientNet features to zarr, a narrow ViT); then the registry's tail
(KongNet on the detector, GrandQC's JPEG round trip and EfficientUNet's
morphology on the semantic engine, NuClick with a click).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GUARDED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys, tempfile
    from importlib.abc import MetaPathFinder

    BLOCKED = {"jax", "jaxlib", "flax", "cv2", "yaml", "PIL", "pandas", "tqdm",
               "psutil", "tiatoolbox_tpu"}

    class Refuse(MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"import of {name} refused")
            return None

    sys.meta_path.insert(0, Refuse())
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    import numpy as np
    import torch
    import tiatoolbox_tpu_torch

    torch.set_num_threads(2)
    names = [m.name for m in pkgutil.walk_packages(
        tiatoolbox_tpu_torch.__path__, "tiatoolbox_tpu_torch.")]
    for name in names + ["chip_smoke"]:
        importlib.import_module(name)

    from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide, synthetic_he_patch
    from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNModel
    from tiatoolbox_tpu_torch.models.engine.io_config import IOPatchPredictorConfig
    from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor
    from tiatoolbox_tpu_torch.tools.stainnorm import get_normalizer
    from tiatoolbox_tpu_torch.wsicore.wsireader import WSIReader

    with tempfile.TemporaryDirectory() as tmp:
        slide = make_synthetic_slide(f"{tmp}/slide.tiff", size=(512, 384), seed=3)
        reader = WSIReader.open(slide)
        from tiatoolbox_tpu_torch.tools.patchextraction import get_patch_extractor

        mask = reader.tissue_mask(method="morphological", resolution=8.0, units="mpp")
        extractor = get_patch_extractor("slidingwindow", input_img=reader, input_mask=mask,
                                        patch_size=(64, 64), stride=(64, 64), resolution=0.5,
                                        units="mpp", min_mask_ratio=0.1)
        assert len(extractor) > 0 and next(iter(extractor)).shape == (64, 64, 3)
        norm = get_normalizer("macenko")
        norm.fit(synthetic_he_patch((96, 96), seed=4))
        constants = norm.prepare_tile_transform(reader.slide_thumbnail(resolution=5, units="power"))
        tiles = np.stack([reader.read_rect((0, 0), (64, 64))] * 2)
        out = norm.transform_tiles(tiles, constants, device="cpu")
        assert out.shape == tiles.shape and out.dtype == torch.uint8
        io = IOPatchPredictorConfig(input_resolutions=[{"units": "mpp", "resolution": 0.5}],
                                    patch_input_shape=(128, 128), stride_shape=(128, 128))
        result = PatchPredictor(model=CNNModel("resnet18", num_classes=9, device="cpu"), batch_size=4,
                                verbose=False, device="cpu").run([slide], patch_mode=False, ioconfig=io)
        probs = result[str(slide)]["probabilities"]
        assert probs.shape[1] == 9 and np.allclose(probs.sum(axis=1), 1, atol=1e-4)

        from tiatoolbox_tpu_torch.models.architecture.unet import UNetModel
        from tiatoolbox_tpu_torch.models.engine import IOSegmentorConfig, SemanticSegmentor

        unet = UNetModel(3, 2, encoder="unet", encoder_levels=[8, 16], device="cpu")
        seg_io = IOSegmentorConfig(input_resolutions=[{"units": "mpp", "resolution": 0.5}],
                                   output_resolutions=[{"units": "mpp", "resolution": 0.5}],
                                   patch_input_shape=(64, 64), patch_output_shape=(32, 32),
                                   stride_shape=(24, 24))
        segmentor = SemanticSegmentor(unet, batch_size=4, verbose=False, device="cpu")
        seg = segmentor.run([slide], patch_mode=False, ioconfig=seg_io, auto_get_mask=False)
        assert seg[str(slide)]["predictions"].shape == (384, 512)
        assert segmentor.last_stage_summary["path"] == "device-canvas+region-feed"
        # the writers: zarr, the AnnotationStore (the native contour tracer),
        # QuPath JSON and the OME-TIFF heatmap (the colour tables)
        for kind, name in (("zarr", "s.zarr"), ("annotationstore", "s.db"), ("qupath", "s.json"),
                           ("ome-tiff", "s.ome.tiff")):
            written = segmentor.save_predictions(seg[str(slide)], kind, tmp, output_file=name)
            assert written.exists(), kind
        from tiatoolbox_tpu_torch.utils.misc import write_probability_heatmap_as_ome_tiff

        write_probability_heatmap_as_ome_tiff(f"{tmp}/jet.ome.tiff", seg[str(slide)]["probabilities"][..., 1], 2)

        from tiatoolbox_tpu_torch.models.architecture import get_pretrained_model
        from tiatoolbox_tpu_torch.models.architecture.hovernet_checkpoint import (
            functional_hovernet_state_dict,
        )
        from tiatoolbox_tpu_torch.models.engine import MultiTaskSegmentor

        small = make_synthetic_slide(f"{tmp}/nuclei.tiff", size=(164, 164), mpp=0.25,
                                     objective_power=40, seed=5)
        hovernet, hv_io = get_pretrained_model("hovernet_fast-pannuke", device="cpu")
        hovernet.load_state_dict(functional_hovernet_state_dict())
        nuclei_engine = MultiTaskSegmentor(hovernet, batch_size=2, verbose=False, device="cpu")
        nuclei = nuclei_engine.run([small], patch_mode=False, ioconfig=hv_io, auto_get_mask=False)
        assert len(nuclei[str(small)]["instances"]) > 0
        from tiatoolbox_tpu_torch.annotation.storage import SQLiteStore

        db = nuclei_engine.save_predictions(nuclei[str(small)], "annotationstore", tmp, output_file="nuclei.db")
        assert len(SQLiteStore(db)) == len(nuclei[str(small)]["instances"])

        # nucleus detection (SCCNN on a tiny slide, its points in a store) and
        # HoVer-Net+'s layer post-processing (the box morphology, the tree contours)
        from tiatoolbox_tpu_torch.models.architecture.hovernetplus import HoVerNetPlus
        from tiatoolbox_tpu_torch.models.engine import NucleusDetector

        sccnn, sccnn_io = get_pretrained_model("sccnn-crchisto", device="cpu")
        detector = NucleusDetector(sccnn, batch_size=16, verbose=False, device="cpu")
        detections = detector.run([small], patch_mode=False, ioconfig=sccnn_io, auto_get_mask=False,
                                  threshold_abs=0.0)[str(small)]
        assert len(detections["coordinates"]) > 0
        db = detector.save_predictions(detections, "annotationstore", tmp, output_file="points.db")
        assert len(SQLiteStore(db)) == len(detections["coordinates"])
        layers = np.zeros((300, 300, 1), np.float32)
        layers[20:280, 20:280] = 1
        layers[60:260, 40:240] = 3
        layers[120:160, 120:160] = 1
        cleaned = HoVerNetPlus._proc_ls(layers)
        assert set(np.unique(cleaned)) == {0, 1, 3}
        assert [v["type"] for v in HoVerNetPlus._get_layer_info(cleaned).values()] == [1, 1, 1, 3, 3]

        # the classifier zoo (a non-ResNet backbone, an idars entry's float
        # patches) and feature extraction (a CNN, EfficientNet and a narrow ViT
        # encoder; the features saved to zarr)
        from tiatoolbox_tpu_torch.models.architecture.vanilla import CNNBackbone
        from tiatoolbox_tpu_torch.models.architecture.vit import TimmBackbone
        from tiatoolbox_tpu_torch.models.engine import DeepFeatureExtractor
        from tiatoolbox_tpu_torch.utils.zarrlite import open_zarr

        zoo = PatchPredictor(model=CNNModel("mobilenet_v3_small", num_classes=2, device="cpu"), batch_size=4,
                             verbose=False, device="cpu").run([slide], patch_mode=False, ioconfig=io)
        assert zoo[str(slide)]["probabilities"].shape[1] == 2
        idars, _ = get_pretrained_model("resnet18-idars-msi", device="cpu")
        patches = np.stack([reader.read_rect((0, 0), (64, 64))] * 3)
        assert PatchPredictor(model=idars, batch_size=2, verbose=False, device="cpu").run(
            patches)["probabilities"].shape == (3, 2)
        for extractor in (CNNBackbone("densenet121", device="cpu"), TimmBackbone("efficientnet_b0", device="cpu")):
            written = DeepFeatureExtractor(extractor, batch_size=4, verbose=False, device="cpu").run(
                [slide], patch_mode=False, ioconfig=io, save_dir=f"{tmp}/{extractor.backbone}", output_type="zarr")
            group = open_zarr(written[str(slide)])
            assert group["features"].shape == (len(group["coordinates"][:]), extractor.num_features)
        from tiatoolbox_tpu_torch.models.architecture.vit import VisionTransformer

        narrow = VisionTransformer(patch_size=8, embed_dim=32, depth=1, num_heads=2, reg_tokens=2, swiglu=True,
                                   init_values=1e-5, img_size=64)
        assert narrow(torch.zeros(1, 64, 64, 3)).shape == (1, 32)

        # the registry's tail: KongNet (V2-S) on the detector, GrandQC's JPEG
        # round trip and EfficientUNet's ellipse morphology on the semantic
        # engine, NuClick's clicks
        from tiatoolbox_tpu_torch.models.architecture.efficientunet_tissue_mask_model import (
            EfficientUNetTissueMaskModel,
        )
        from tiatoolbox_tpu_torch.models.architecture.grandqc import GrandQCModel
        from tiatoolbox_tpu_torch.models.architecture.kongnet import KongNet
        from tiatoolbox_tpu_torch.models.architecture.nuclick import NuClick

        kong = KongNet(2, [3, 3], [2, 5], 3, 0.0, variant="efficientnetv2_s", device="cpu")
        found = NucleusDetector(kong, batch_size=4, verbose=False, device="cpu").run(
            [small], patch_mode=False, auto_get_mask=False, ioconfig=IOSegmentorConfig(
                input_resolutions=[{"units": "mpp", "resolution": 0.5}],
                output_resolutions=[{"units": "mpp", "resolution": 0.5}],
                patch_input_shape=(64, 64), stride_shape=(56, 56)))[str(small)]
        assert set(np.unique(found["types"])) <= {0, 1}
        for tissue in (GrandQCModel(device="cpu"), EfficientUNetTissueMaskModel(device="cpu")):
            tio = IOSegmentorConfig(input_resolutions=[{"units": "mpp", "resolution": 2.0}],
                                    output_resolutions=[{"units": "mpp", "resolution": 2.0}],
                                    patch_input_shape=(64, 64), stride_shape=(48, 48))
            probs = SemanticSegmentor(tissue, batch_size=4, verbose=False, device="cpu").run(
                [slide], patch_mode=False, ioconfig=tio, auto_get_mask=False)[str(slide)]["probabilities"]
            assert tissue.postproc(probs).shape == probs.shape[:2]
        clicks = np.zeros((1, 64, 64, 5), np.float32)
        clicks[0, 30, 30, 3] = 1
        nuclick = NuClick(device="cpu")
        masks = NuClick.infer_batch(nuclick, clicks)
        assert NuClick.postproc(masks, nuc_points=clicks[..., 3], do_reconstruction=True).shape == (1, 64, 64)

    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("GUARDED_OK", len(names))
    """
)


def test_port_imports_and_runs_without_jax_cv2_or_yaml() -> None:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", GUARDED_RUN],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
        check=False,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "GUARDED_OK" in proc.stdout


def test_no_top_level_import_of_refused_packages() -> None:
    import re

    pattern = re.compile(r"^\s*(import|from) (jax|flax|cv2|yaml|PIL|tiatoolbox_tpu)\b", re.M)
    sources = [REPO / "chip_smoke.py", *sorted((REPO / "tiatoolbox_tpu_torch").rglob("*.py"))]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders
