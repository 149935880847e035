"""Sample data (counterpart of ``tiatoolbox_tpu/data/__init__.py``).

JAX's helpers make their samples synthetically and cache them under
``rcParam["TIATOOLBOX_HOME"]/samples`` (:19-49); the port's are the same,
on the port's writers (``data/synth.py``). ``stain_norm_target`` is JAX's
image, pixel for pixel within the stand-in's known float32 cubic gap
(``synth.synthetic_he_patch_exact``). ``_fetch_remote_sample`` keeps only
JAX's synthetic branch (:52-109): the port never downloads, and its
registry of sample names is carried below as a dict (JAX reads it from
``data/remote_samples.yaml``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import rcParam

# JAX's ``data/remote_samples.yaml``: each sample's file name and the kind of
# synthetic stand-in made for it
REMOTE_SAMPLES: dict = {
    "svs-1-small": {"filename": "CMU-1-Small-Region.svs", "synthetic": "slide"},
    "ndpi-1": {"filename": "CMU-1.ndpi", "synthetic": "slide"},
    "dicom-1": {"filename": "CMU-1-Small-Region.dicom.zip", "synthetic": "dicom"},
    "jp2-omnyx-small": {"filename": "test1.jp2", "synthetic": "jp2"},
    "stainnorm-source": {"filename": "source.png", "synthetic": "patch"},
    "sample-patch-1": {"filename": "sample_patch1.png", "synthetic": "patch"},
}


def _samples_home() -> Path:
    home = Path(rcParam["TIATOOLBOX_HOME"]) / "samples"
    home.mkdir(parents=True, exist_ok=True)
    return home


def stain_norm_target() -> np.ndarray:
    """The default stain-normalization target image (synthetic H&E, 224^2, seed 1234)."""
    from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch_exact

    return synthetic_he_patch_exact(size=(224, 224), seed=1234)


def sample_slide_path(name: str = "synthetic") -> Path:
    """Path to a cached synthetic sample slide, generating it if needed."""
    from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide

    path = _samples_home() / f"{name}.tiff"
    if not path.exists():
        make_synthetic_slide(path)
    return path


def small_svs() -> Path:
    """A small cached synthetic pyramidal slide (1024x768 at 0.5 mpp)."""
    from tiatoolbox_tpu_torch.data.synth import make_synthetic_slide

    path = _samples_home() / "small_svs.tiff"
    if not path.exists():
        make_synthetic_slide(path, size=(1024, 768), mpp=0.5)
    return path


def _fetch_remote_sample(key: str, tmp_path: Path | None = None) -> Path:
    """The synthetic stand-in of a registered sample, made once and cached.

    JAX's writes its JPEG 2000 stand-in with cv2; the port writes the same
    pixels as a lossless tiled JP2 (``wsicore/jp2.py::write_tiled_jp2``).
    """
    from tiatoolbox_tpu_torch.data import synth

    if key not in REMOTE_SAMPLES:
        msg = f"Unknown remote sample: {key!r}."
        raise KeyError(msg)
    entry = REMOTE_SAMPLES[key]
    dest_dir = Path(tmp_path) if tmp_path else _samples_home()
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / entry["filename"]
    kind = entry["synthetic"]
    if kind == "slide":
        out = dest.with_suffix(".tiff")
        if not out.exists():
            synth.make_synthetic_slide(out)
    elif kind == "dicom":
        out = dest.with_suffix(".dcm")
        if not out.exists():
            synth.make_synthetic_dicom(out)
    elif kind == "jp2":
        from tiatoolbox_tpu_torch.wsicore.jp2 import write_tiled_jp2

        out = dest.with_suffix(".jp2")
        if not out.exists():
            write_tiled_jp2(out, synth.synthetic_he_patch_exact((1024, 768), seed=7))
    else:  # patch
        from tiatoolbox_tpu_torch.utils.misc import imwrite

        out = dest.with_suffix(".png")
        if not out.exists():
            imwrite(out, synth.synthetic_he_patch_exact((224, 224), seed=9))
    return out
