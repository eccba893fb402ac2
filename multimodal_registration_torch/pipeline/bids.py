"""BIDS dataset discovery and filename derivation (the port's copy of
``multimodal_registration_tpu/pipeline/bids.py``).

Parity target: the per-subject filename logic of the pipeline scripts
(`pipeline_bids_register_evaluate.sh:91-120`): subjects ``sub-*`` with
optional sessions ``ses-*``, anatomical images under ``anat/`` named
``<sub>[_<ses>]_<contrast>.nii.gz``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List


@dataclass
class SubjectImages:
    subject: str  # e.g. "sub-01" or "sub-01/ses-01"
    anat_dir: str
    files: dict  # contrast -> path


def discover_subjects(path_data: str) -> List[str]:
    """List subject (and subject/session) identifiers with an anat dir."""
    out = []
    for sub in sorted(os.listdir(path_data)):
        if not sub.startswith("sub-"):
            continue
        sub_dir = os.path.join(path_data, sub)
        if not os.path.isdir(sub_dir):
            continue
        sessions = [s for s in sorted(os.listdir(sub_dir)) if s.startswith("ses-")]
        if sessions:
            for ses in sessions:
                if os.path.isdir(os.path.join(sub_dir, ses, "anat")):
                    out.append(f"{sub}/{ses}")
        elif os.path.isdir(os.path.join(sub_dir, "anat")):
            out.append(sub)
    return out


def subject_images(path_data: str, subject: str) -> SubjectImages:
    anat = os.path.join(path_data, subject, "anat")
    prefix = subject.replace("/", "_")  # sub-01/ses-01 -> sub-01_ses-01
    files = {}
    if os.path.isdir(anat):
        for f in sorted(os.listdir(anat)):
            if f.endswith((".nii", ".nii.gz")) and f.startswith(prefix):
                stem = f[: -len(".nii.gz")] if f.endswith(".nii.gz") else f[: -len(".nii")]
                contrast = stem[len(prefix) + 1 :] if stem.startswith(prefix + "_") else stem
                files[contrast] = os.path.join(anat, f)
    return SubjectImages(subject=subject, anat_dir=anat, files=files)
