"""The port runs where only torch, numpy and scipy are installed.

A subprocess installs a ``sys.meta_path`` finder that refuses jax, flax,
cv2, yaml, PIL, pandas, tqdm, psutil and the JAX package, imports every
module of ``tiatoolbox_tpu_torch`` and ``chip_smoke``, and runs the slices
(stain transform, whole-slide patch classification and whole-slide
semantic segmentation) on the CPU on a tiny slide.
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
