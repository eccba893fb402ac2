"""Evaluator CLIs of the port, drop-in equivalents of the JAX package's
(``multimodal_registration_tpu/evalx/cli.py``) with the same CSV headers
and append rules, plus ``--device`` (default: the GPU):

  * ``eval_on_sc_seg``     (``eval_reg_on_sc_seg.py``, metrics_on_sc_seg.csv,
    with the min-dice exit code of the opt-affine pipeline),
  * ``eval_with_mi``       (``eval_reg_with_mi.py``, nmi.csv),
  * ``eval_with_jacobian`` (``eval_reg_with_jacobian.py``, jacobian_det.csv),

reached through ``python -m multimodal_registration_torch <command>``.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import os
import threading

import numpy as np

from multimodal_registration_torch.evalx.jacobian import folding_summary
from multimodal_registration_torch.evalx.nmi import (
    detect_zero_padding, normalized_mutual_information)
from multimodal_registration_torch.evalx.overlap import overlap_metrics
from multimodal_registration_torch.utils import nifti


def _load(path):
    # the extension is looked for in the basename: a dotted directory must
    # not make an extension-less stem look like a file name
    if "." in os.path.basename(path):
        return nifti.load(path)
    return nifti.load(f"{path}.nii.gz")


# one header check and append at a time when evaluators share a process
_CSV_LOCK = threading.Lock()


def _write_row(out_file: str, header: list, values: list, append: bool):
    with _CSV_LOCK:
        if not append or not os.path.isfile(out_file):
            with open(out_file, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=header).writeheader()
        with open(out_file, "a", newline="") as f:
            w = csv.writer(f, delimiter=",")
            w.writerow([datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")]
                       + [str(v) for v in values])


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; pass cpu to run on the CPU)")


def eval_on_sc_seg_arrays(fx, moving, moved, sub_id, out_file, append=True, min_dice=0,
                          last_eval=1, device=None):
    """Array-level core. Returns ``(exit_code, before, after)``."""
    m_mov = overlap_metrics(fx, moving, device)
    m_mvd = overlap_metrics(fx, moved, device)

    # the affine-fallback gate of the opt-affine pipeline
    if 100 * m_mvd["dice"] < min_dice and not last_eval:
        return 1, m_mov, m_mvd

    header = [
        "Timestamp", "Subject", "Dice_before_registration", "Dice_after_registration",
        "Jaccard_before", "Jaccard_after", "Sensitivity_before", "Sensitivity_after",
        "Precision_before", "Precision_after", "Specificity_before", "Specificity_after",
        "Accuracy_before", "Accuracy_after",
    ]
    values = [
        sub_id, m_mov["dice"], m_mvd["dice"], m_mov["jaccard"], m_mvd["jaccard"],
        m_mov["sensitivity"], m_mvd["sensitivity"], m_mov["precision"], m_mvd["precision"],
        m_mov["specificity"], m_mvd["specificity"], m_mov["accuracy"], m_mvd["accuracy"],
    ]
    _write_row(out_file, header, values, append)
    return 0, m_mov, m_mvd


def eval_on_sc_seg(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate registration on SC segmentations")
    p.add_argument("--fx-seg-path", required=True)
    p.add_argument("--moving-seg-path", required=True)
    p.add_argument("--warped-seg-path", required=True)
    p.add_argument("--sub-id", required=True)
    p.add_argument("--out-file", default="metrics_on_sc_seg.csv")
    p.add_argument("--append", type=int, default=1, choices=[0, 1])
    p.add_argument("--min-dice", type=int, default=0)
    p.add_argument("--last-eval", type=int, default=1, choices=[0, 1])
    _add_device_flag(p)
    a = p.parse_args(argv)

    code, _, _ = eval_on_sc_seg_arrays(
        _load(a.fx_seg_path).get_fdata(),
        _load(a.moving_seg_path).get_fdata(),
        _load(a.warped_seg_path).get_fdata(),
        a.sub_id, a.out_file, bool(a.append), a.min_dice, a.last_eval, a.device,
    )
    return code


def eval_with_mi_arrays(fx, moving, moved, sub_id, out_file, append=True, device=None) -> dict:
    """Array-level core; returns the NMI values written to the CSV row."""
    x0, y0, z0, x1, y1, z1 = detect_zero_padding(moving)
    box = (slice(x0, x1 + 1), slice(y0, y1 + 1), slice(z0, z1 + 1))
    fx, moving, moved = fx[box], moving[box], moved[box]

    nmi_fm = normalized_mutual_information(fx, moving, device=device)
    nmi_fd = normalized_mutual_information(fx, moved, device=device)
    nmi_md = normalized_mutual_information(moving, moved, device=device)
    perc = 100 * (nmi_fd - nmi_fm) / nmi_fm

    header = [
        "Timestamp", "Subject", "NMI_before_registration", "NMI_after_registration",
        "NMI_between_moving_and_moved_images", "Percentage_nmi_improvement_registration",
    ]
    _write_row(out_file, header, [sub_id, nmi_fm, nmi_fd, nmi_md, np.round(perc, 2)], append)
    return {"nmi_before": nmi_fm, "nmi_after": nmi_fd, "nmi_moving_moved": nmi_md,
            "pct_improvement": perc}


def eval_with_mi(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate registration with NMI")
    p.add_argument("--fx-im-path", required=True)
    p.add_argument("--moving-im-path", required=True)
    p.add_argument("--warped-im-path", required=True)
    p.add_argument("--sub-id", required=True)
    p.add_argument("--out-file", default="nmi.csv")
    p.add_argument("--append", type=int, default=1, choices=[0, 1])
    _add_device_flag(p)
    a = p.parse_args(argv)

    eval_with_mi_arrays(
        _load(a.fx_im_path).get_fdata(),
        _load(a.moving_im_path).get_fdata(),
        _load(a.warped_im_path).get_fdata(),
        a.sub_id, a.out_file, bool(a.append), a.device,
    )
    return 0


def eval_with_jacobian_arrays(field, affine, sub_id, out_file, out_im_path, append=True,
                              device=None) -> dict:
    """Array-level core; returns the folding summary (without the
    determinant volume, which is written to ``out_im_path`` in
    :func:`nifti.output_dtype`: float32, or float64 under ``MMREG_F64_OUTPUTS``)."""
    summary = folding_summary(field, device)
    det = summary.pop("det")
    nifti.save(nifti.NiftiImage(det[..., None].astype(nifti.output_dtype()), affine), out_im_path)

    header = [
        "Timestamp", "Subject", "Percentage_negative_detJa[%]", "Median_detJa",
        "Mean_detJa", "Std_detJa", "N_total_voxels", "N_voxels_negatives_detJa",
    ]
    _write_row(
        out_file, header,
        [sub_id, summary["percentage_negative_detJa"], summary["median_detJa"],
         summary["mean_detJa"], summary["std_detJa"], summary["n_total_detJa"],
         summary["n_negatives_detJa"]],
        append,
    )
    return summary


def eval_with_jacobian(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate a deformation field's Jacobian")
    p.add_argument("--def-field-path", required=True)
    p.add_argument("--sub-id", required=True)
    p.add_argument("--out-file", default="jacobian_det.csv")
    p.add_argument("--out-im-path", default="detJa.nii.gz")
    p.add_argument("--append", type=int, default=1, choices=[0, 1])
    _add_device_flag(p)
    a = p.parse_args(argv)

    img = _load(a.def_field_path)
    eval_with_jacobian_arrays(img.get_fdata(), img.affine, a.sub_id, a.out_file,
                              a.out_im_path, bool(a.append), a.device)
    return 0
