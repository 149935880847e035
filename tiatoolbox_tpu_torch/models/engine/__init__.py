"""Inference engines of the port."""

from tiatoolbox_tpu_torch.models.engine.io_config import (  # noqa: F401
    IOInstanceSegmentorConfig,
    IOPatchPredictorConfig,
    IOSegmentorConfig,
    ModelIOConfigABC,
)
from tiatoolbox_tpu_torch.models.engine.patch_predictor import PatchPredictor  # noqa: F401
from tiatoolbox_tpu_torch.models.engine.semantic_segmentor import SemanticSegmentor  # noqa: F401
from tiatoolbox_tpu_torch.models.engine.multi_task_segmentor import (  # noqa: F401, E402
    MultiTaskSegmentor,
    NucleusInstanceSegmentor,
)
from tiatoolbox_tpu_torch.models.engine.nucleus_detector import NucleusDetector  # noqa: F401, E402
