"""WSI registration tools (counterpart of ``tiatoolbox_tpu/tools/registration``)."""

from tiatoolbox_tpu_torch.tools.registration.wsi_registration import (  # noqa: F401
    AffineWSITransformer,
    DFBRegister,
    apply_bspline_transform,
    estimate_bspline_transform,
    match_histograms,
    prealignment,
)
