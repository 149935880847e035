"""Deep feature extraction engine (counterpart of ``tiatoolbox_tpu/models/engine/deep_feature_extractor.py``).

``DeepFeatureExtractor`` (:16-47) runs a feature model (``CNNBackbone``,
``TimmBackbone``) over patches or a slide's patch grid with the engine's
loop, renames the outputs' ``probabilities`` to ``features``, and returns
the dict or writes ``features``, ``coordinates`` and ``labels`` to a zarr
group (the port's ``utils/zarrlite.py``); other output types raise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tiatoolbox_tpu_torch.models.engine.engine_abc import EngineABC


class DeepFeatureExtractor(EngineABC):
    """Extract backbone features per patch or per slide-grid cell."""

    def post_process_patches(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Rename ``probabilities`` to ``features``."""
        out = dict(raw_predictions)
        out["features"] = out.pop("probabilities")
        return out

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:
        """Same renaming for a slide's outputs."""
        return self.post_process_patches(raw_predictions, **kwargs)

    def save_predictions(
        self,
        processed_predictions: dict,
        output_type: str,
        save_dir=None,
        output_file: str | None = None,
        **kwargs,  # noqa: ARG002
    ):
        """Return the dict (``"dict"``) or write ``<save_dir>/<output_file>``
        (``output.zarr`` by default) and return its path (``"zarr"``)."""
        kind = output_type.lower()
        if kind == "zarr":
            from tiatoolbox_tpu_torch.utils.zarrlite import ZarrGroup

            if save_dir is None:
                msg = f"`save_dir` must be provided for output_type={output_type}."
                raise ValueError(msg)
            out_path = Path(save_dir) / (output_file or "output.zarr")
            group = ZarrGroup.create(out_path)
            for key in ("features", "coordinates", "labels"):
                if key in processed_predictions:
                    group.from_array(key, np.asarray(processed_predictions[key]))
            return out_path
        if kind == "dict":
            return processed_predictions
        msg = f"Unsupported output_type: {output_type}"
        raise ValueError(msg)
