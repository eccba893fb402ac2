from multimodal_registration_torch.evalx.jacobian import folding_summary, jacobian_determinant
from multimodal_registration_torch.evalx.nmi import (
    detect_zero_padding,
    normalized_mutual_information,
)
from multimodal_registration_torch.evalx.overlap import overlap_metrics

__all__ = [
    "detect_zero_padding",
    "folding_summary",
    "jacobian_determinant",
    "normalized_mutual_information",
    "overlap_metrics",
]
