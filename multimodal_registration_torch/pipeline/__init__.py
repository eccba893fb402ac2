"""The BIDS batch pipeline of the port (``python -m multimodal_registration_torch
pipeline``), counterpart of ``multimodal_registration_tpu/pipeline/``."""

from multimodal_registration_torch.pipeline.batch import run_batch
from multimodal_registration_torch.pipeline.bids import discover_subjects, subject_images
from multimodal_registration_torch.pipeline.qc import QCReport
from multimodal_registration_torch.pipeline.runner import PipelineConfig, SubjectResult, run_subject
from multimodal_registration_torch.pipeline.segment import (
    SCTSegmenter,
    Segmenter,
    ThresholdSegmenter,
    centermass_affine_field,
    default_segmenter,
)

__all__ = [
    "PipelineConfig",
    "QCReport",
    "SCTSegmenter",
    "Segmenter",
    "SubjectResult",
    "ThresholdSegmenter",
    "centermass_affine_field",
    "default_segmenter",
    "discover_subjects",
    "run_batch",
    "run_subject",
    "subject_images",
]
