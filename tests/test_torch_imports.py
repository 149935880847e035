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
with SCCNN and HoVer-Net+'s layer post-processing.
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
