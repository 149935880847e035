"""Dataset information classes (counterpart of ``tiatoolbox_tpu/models/dataset/info.py``).

No download is made: ``KatherPatchDataset`` reads a local copy of
Kather100k (``<dir>/<CLASS>/*.tif``, one folder a class) when there is
one, and otherwise builds JAX's synthetic stand-in (JAX :36-99): the same
labels, and the same 128 patches but for 10 of their 19.3 million values,
one level apart (``data/synth.py::synthetic_he_patch_exact``).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch import logger, rcParam
from tiatoolbox_tpu_torch.models.dataset.dataset_abc import PatchDatasetABC

# Training label order of the kather100k pretrained zoo: class id i is
# KATHER_CLASSES[i] in the models' logits. Not alphabetical.
KATHER_CLASSES = [
    "BACK",
    "NORM",
    "DEB",
    "TUM",
    "ADI",
    "MUC",
    "MUS",
    "STR",
    "LYM",
]


class DatasetInfoABC(ABC):
    """Base for dataset info providers: inputs, labels, label names."""

    @abstractmethod
    def __init__(self) -> None:
        raise NotImplementedError


def _read_patch(path: Path) -> np.ndarray:
    """A patch file as uint8 RGB: TIFF through the port's reader, others through ``imread``."""
    from tiatoolbox_tpu_torch.utils import misc

    if path.suffix.lower() in (".tif", ".tiff"):
        from tiatoolbox_tpu_torch.wsicore.tiffio import TiffFile

        with TiffFile(path) as tif:
            page = tif.pages[0]
            return tif.read_region(0, (0, 0), (page.width, page.height))
    return misc.imread(path)


class KatherPatchDataset(PatchDatasetABC):
    """Kather100k validation patches.

    Args:
        save_dir_path: Directory holding the extracted dataset
            (``<dir>/<CLASS>/*.tif``). When None, looks under
            ``$TIATOOLBOX_HOME/dataset/kather100k`` and falls back to a
            deterministic synthetic stand-in (128 patches of 224², 9
            classes) for offline pipeline runs.
    """

    def __init__(self, save_dir_path: str | Path | None = None) -> None:
        super().__init__()
        self.label_names = KATHER_CLASSES
        if save_dir_path is None:
            save_dir_path = Path(rcParam["TIATOOLBOX_HOME"]) / "dataset" / "kather100k"
        save_dir_path = Path(save_dir_path)
        if save_dir_path.exists():
            inputs, labels = [], []
            for label_idx, name in enumerate(KATHER_CLASSES):
                class_dir = save_dir_path / name
                if not class_dir.exists():
                    continue
                for img_path in sorted(class_dir.glob("*.tif")):
                    inputs.append(img_path)
                    labels.append(label_idx)
            if not inputs:
                msg = f"No Kather100k patches found under {save_dir_path}."
                raise ValueError(msg)
            self.inputs = inputs
            self.labels = labels
        else:
            logger.warning(
                "Kather100k not found at %s; using a synthetic stand-in "
                "(offline build). Place the extracted dataset there for "
                "real validation.",
                save_dir_path,
            )
            from tiatoolbox_tpu_torch.data.synth import synthetic_he_patch_exact

            rng = np.random.default_rng(0)
            self.inputs = np.stack([synthetic_he_patch_exact((224, 224), seed=int(s)) for s in range(128)])
            self.labels = rng.integers(0, 9, size=128).tolist()

    def __getitem__(self, idx: int) -> dict:
        patch = self.inputs[idx]
        if isinstance(patch, (str, Path)):
            patch = _read_patch(Path(patch))
        patch = self._preproc(np.asarray(patch))
        return {"image": patch, "label": self.labels[idx]}
