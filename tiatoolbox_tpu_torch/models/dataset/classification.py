"""Dataset-keyed preprocessing (counterpart of ``tiatoolbox_tpu/models/dataset/classification.py``).

``predefined_preproc_func`` (:13-32): for kather100k and pcam the
preprocessing is the uint8 identity (scaling to [0, 1] happens on the device
in ``ModelABC.apply_u8``); for idars it is ``idars_preproc``, a float32
normalisation on the host.
"""

from __future__ import annotations

import numpy as np


def _identity(patch) -> np.ndarray:
    return np.asarray(patch)


def predefined_preproc_func(dataset_name: str):
    """Per-dataset patch preprocessing function ("kather100k", "pcam" or "idars")."""
    from tiatoolbox_tpu_torch.models.architecture.idars import idars_preproc

    preproc_dict = {"kather100k": _identity, "pcam": _identity, "idars": idars_preproc}
    if dataset_name not in preproc_dict:
        msg = f"Predefined preprocessing for dataset `{dataset_name}` does not exist."
        raise ValueError(msg)
    return preproc_dict[dataset_name]
