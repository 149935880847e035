"""Patch-level classification engine (counterpart of ``tiatoolbox_tpu/models/engine/patch_predictor.py``).

Adds argmax ``predictions`` (and optional probability suppression) to the
engine's softmax outputs.
"""

from __future__ import annotations

from tiatoolbox_tpu_torch.models.engine.engine_abc import EngineABC, EngineABCRunParams, argmax_probabilities


class PredictorRunParams(EngineABCRunParams, total=False):
    """``PatchPredictor.run`` keyword arguments (JAX ``patch_predictor.py:15-17``, with keys)."""

    return_probabilities: bool


class PatchPredictor(EngineABC):
    """WSI/patch classifier engine (e.g. resnet18-kather100k).

    Run parameters add ``return_probabilities`` (default True): when
    False, only argmax predictions are kept.
    """

    def __init__(
        self,
        model,
        weights=None,
        batch_size: int = 32,
        num_loader_workers: int = 8,
        device: str | None = None,
        *,
        verbose: bool = True,
    ) -> None:
        super().__init__(
            model=model,
            weights=weights,
            batch_size=batch_size,
            num_loader_workers=num_loader_workers,
            device=device,
            verbose=verbose,
        )
        self.return_probabilities = True

    _RUN_PARAMS = tuple(PredictorRunParams.__annotations__)

    def post_process_patches(self, raw_predictions: dict, **kwargs) -> dict:  # noqa: ARG002
        """Add argmax ``predictions``; drop probabilities if not wanted."""
        output = dict(raw_predictions)
        output["predictions"] = argmax_probabilities(output["probabilities"])
        if not self.return_probabilities:
            del output["probabilities"]
        return output

    def post_process_wsi(self, raw_predictions: dict, **kwargs) -> dict:
        """Same argmax processing for WSI-mode outputs."""
        return self.post_process_patches(raw_predictions, **kwargs)
