"""Per-subject pipeline: register → segment → evaluate → QC, with the
optional center-of-mass-affine fallback gate (the port's copy of
``multimodal_registration_tpu/pipeline/runner.py``).

Parity target: the three bash pipelines driven by ``sct_run_batch``:
  * basic: `pipeline_bids_register_evaluate.sh` — copy data, register,
    segment fx/mov/moved, run the three evaluators, QC, output checks,
  * opt-affine: `pipeline_bids_register_evaluate_opt_affine.sh` — if SC Dice
    after deformable registration is below ``min_sc_dice`` (default 80%,
    `:71`), segment the originals, slice-wise center-of-mass affine
    (`:156-174`), re-register on the affine-aligned volume and re-evaluate,
  * two-step: `pipeline_bids_register_evaluate_two_steps.sh` — the cascade
    CLI with two models.

Design difference: the reference forks one shell per subject and rebuilds
the TF graph each time; here subjects stream through ONE process that holds
the model on the GPU. Device work (registration, the affine fallback's warp,
the evaluators) runs under one lock, so ``--jobs N`` worker threads overlap
only host work: the kernel wrappers keep process-wide caches (K1's and K8's
prepared weights, the lazy int8 calibration of a ``Registrar``).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from multimodal_registration_torch.evalx.overlap import overlap_metrics
from multimodal_registration_torch.infer.cascade import register_two_steps
from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar, register
from multimodal_registration_torch.pipeline.bids import subject_images
from multimodal_registration_torch.pipeline.qc import QCReport, warped_grid_mosaic
from multimodal_registration_torch.pipeline.segment import (
    Segmenter,
    apply_affine_field,
    centermass_affine_field,
    default_segmenter,
    rigid_affine_field,
)
from multimodal_registration_torch.utils import nifti

# serializes error-log appends from `--jobs N` worker threads
_ERRLOG_LOCK = threading.Lock()
# serializes the device work of `--jobs N` worker threads (module docstring)
_DEVICE_LOCK = threading.Lock()


@dataclass
class PipelineConfig:
    fx_contrast: str = "T2w"
    mov_contrast: str = "T1w"
    opt_affine: bool = False
    min_sc_dice: int = 80  # percent (opt_affine gate, opt_affine.sh:71)
    # 'centermass' = reference parity (slice-wise in-plane COM translation,
    # opt_affine.sh:174 — translation-only, inherits the reference's failure
    # on rotation-dominant misalignment, see PARITY.md / the rotation study);
    # 'rigid' = opt-in principal-axes rotation+translation fallback.
    affine_fallback_mode: str = "centermass"
    two_step: bool = False
    csv_dir: str = "."
    debugging: bool = True  # keep intermediate files (sh DEBUGGING flag)
    keep_ori_naming_loc: bool = False  # sh KEEP_ORI_NAMING_LOC flag
    reorganize: bool = True  # origin/res/seg/add_res layout (sh:166-221)


@dataclass
class SubjectResult:
    subject: str
    ok: bool
    seconds: float
    metrics: dict = field(default_factory=dict)
    missing_files: list = field(default_factory=list)
    error: Optional[str] = None
    used_affine_fallback: bool = False
    # per-phase wall-clock (copy/register/segment/evaluate/qc/reorganize) —
    # the fine-grained version of the reference's per-subject runtime report
    # (`pipeline_bids_register_evaluate.sh:245-253`)
    timings: dict = field(default_factory=dict)


def _evaluate(sub_id, fx_seg_p, mov_seg_p, moved_seg_p, fx_p, mov_p, moved_p,
              warp_p, csv_dir, moved_arr=None, warp_arr=None, device=None):
    """Run the three evaluators via the array-level library API, appending the
    same CSVs the reference writes (`pipeline_bids_register_evaluate.sh:142-156`).

    ``moved_arr``/``warp_arr``: the just-computed volumes, passed in-memory so
    the largest outputs aren't decoded back from disk; values equal the files
    at ``moved_p``/``warp_p`` (both written f32). Returns the after-overlap
    metrics and the folding summary so the caller doesn't recompute them.
    The evaluators run on ``device``."""
    from multimodal_registration_torch.evalx.cli import (
        eval_on_sc_seg_arrays,
        eval_with_jacobian_arrays,
        eval_with_mi_arrays,
    )

    _, _, m_after = eval_on_sc_seg_arrays(
        nifti.load(fx_seg_p, cached=True).get_fdata(),
        nifti.load(mov_seg_p, cached=True).get_fdata(),
        nifti.load(moved_seg_p, cached=True).get_fdata(),
        sub_id, os.path.join(csv_dir, "metrics_on_sc_seg.csv"), device=device,
    )
    if moved_arr is None:
        moved_arr = nifti.load(moved_p, cached=True).get_fdata()
    eval_with_mi_arrays(
        nifti.load(fx_p, cached=True).get_fdata(),
        nifti.load(mov_p, cached=True).get_fdata(),
        moved_arr, sub_id, os.path.join(csv_dir, "nmi.csv"), device=device,
    )
    warp_img = nifti.load(warp_p, cached=True)  # cache hit; affine + fallback data
    jac = eval_with_jacobian_arrays(
        warp_arr if warp_arr is not None else warp_img.get_fdata(),
        warp_img.affine, sub_id,
        os.path.join(csv_dir, "jacobian_det.csv"),
        os.path.join(os.path.dirname(moved_p), "detJa.nii.gz"), device=device,
    )
    return m_after, jac


def _reorganize_outputs(work, pcfg, fx_p, mov_p, fx_proc_p, moved_p):
    """Output layout parity with `pipeline_bids_register_evaluate.sh:166-221`:
    originals (+ JSON sidecars) → ``origin/``; processed fixed + moved →
    ``res/`` (or back under original names if ``keep_ori_naming_loc``); with
    ``debugging``: segmentations → ``seg/``, everything else → ``add_res/``;
    otherwise leftovers are deleted. Returns the two final output paths."""

    def _mv(src, dstdir):
        os.makedirs(dstdir, exist_ok=True)
        dst = os.path.join(dstdir, os.path.basename(src))
        if os.path.exists(src):
            shutil.move(src, dst)
        return dst

    origin = os.path.join(work, "origin")
    _mv(fx_p, origin)
    _mv(mov_p, origin)
    for f in list(os.listdir(work)):
        if f.endswith(".json"):
            _mv(os.path.join(work, f), origin)

    res = os.path.join(work, "res")
    final_fx = _mv(fx_proc_p, res)
    final_moved = _mv(moved_p, res)

    if pcfg.debugging:
        seg_dir = os.path.join(work, "seg")
        add_res = os.path.join(work, "add_res")
        for f in sorted(os.listdir(work)):
            p = os.path.join(work, f)
            if not os.path.isfile(p) or not f.endswith(".nii.gz"):
                continue
            _mv(p, seg_dir if f.endswith("_seg.nii.gz") else add_res)
    else:
        for f in list(os.listdir(work)):
            p = os.path.join(work, f)
            if os.path.isfile(p) and f.endswith(".nii.gz"):
                os.remove(p)

    if pcfg.keep_ori_naming_loc:
        final_fx = shutil.move(final_fx, os.path.join(work, os.path.basename(fx_p)))
        final_moved = shutil.move(final_moved, os.path.join(work, os.path.basename(mov_p)))
        shutil.rmtree(res, ignore_errors=True)
    return final_fx, final_moved


def run_subject(
    cfg: InferenceConfig,
    pcfg: PipelineConfig,
    registrar: Registrar,
    path_data: str,
    path_out: str,
    subject: str,
    segmenter: Segmenter | None = None,
    qc: QCReport | None = None,
    registrar2: Registrar | None = None,
    preloaded: dict | None = None,  # contrast -> (data, affine) from prefetch
) -> SubjectResult:
    t0 = time.time()
    segmenter = segmenter or default_segmenter()
    dev = registrar.device
    timings: dict = {}
    _last = [t0]

    def _mark(phase: str) -> None:
        now = time.time()
        timings[phase] = round(timings.get(phase, 0.0) + (now - _last[0]), 3)
        _last[0] = now

    try:
        # ---- copy subject data (rsync parity, sh:83-89) ----
        imgs = subject_images(path_data, subject)
        if pcfg.fx_contrast not in imgs.files or pcfg.mov_contrast not in imgs.files:
            return SubjectResult(
                subject, False, time.time() - t0,
                error=f"missing contrasts {pcfg.fx_contrast}/{pcfg.mov_contrast} "
                      f"in {sorted(imgs.files)}",
            )
        work = os.path.join(path_out, subject.replace("/", "_"))
        os.makedirs(work, exist_ok=True)
        prefix = subject.replace("/", "_")
        fx_p = os.path.join(work, f"{prefix}_{pcfg.fx_contrast}.nii.gz")
        mov_p = os.path.join(work, f"{prefix}_{pcfg.mov_contrast}.nii.gz")
        shutil.copy(imgs.files[pcfg.fx_contrast], fx_p)
        shutil.copy(imgs.files[pcfg.mov_contrast], mov_p)
        for src in (imgs.files[pcfg.fx_contrast], imgs.files[pcfg.mov_contrast]):
            sidecar = src.replace(".nii.gz", ".json").replace(".nii", ".json")
            if os.path.exists(sidecar):
                shutil.copy(sidecar, work)  # BIDS sidecars travel too (rsync parity)

        pre_imgs = {}
        if preloaded:
            for contrast, (data, affine) in preloaded.items():
                pre_imgs[contrast] = nifti.NiftiImage(data, affine)

        def do_register(mov_path):
            if pcfg.two_step and registrar2 is not None:
                return register_two_steps(
                    cfg, registrar, registrar2, fx_p, mov_path, fx_contrast=pcfg.fx_contrast
                )
            return register(
                cfg, registrar, fx_p, mov_path, fx_contrast=pcfg.fx_contrast,
                fixed_nii=pre_imgs.get(pcfg.fx_contrast),
                moving_nii=pre_imgs.get(pcfg.mov_contrast) if mov_path == mov_p else None,
            )

        _mark("copy")
        with _DEVICE_LOCK:
            out = do_register(mov_p)
        _mark("register")
        for k, v in (out.get("timings") or {}).items():
            timings[f"register.{k}"] = v
        mov_stem = mov_p.split(".")[0]
        fx_stem = fx_p.split(".")[0]
        moved_p = f"{mov_stem}_proc_reg_to_{pcfg.fx_contrast}.nii.gz"
        warp_p = f"{mov_stem}_proc_field_to_{pcfg.fx_contrast}.nii.gz"
        fx_proc_p = f"{fx_stem}_proc.nii.gz"
        mov_proc_p = f"{mov_stem}_proc.nii.gz"

        # ---- segment fx / mov / moved (sh:122-138) ----
        fx_seg_p = f"{fx_stem}_proc_seg.nii.gz"
        mov_seg_p = f"{mov_stem}_proc_seg.nii.gz"
        moved_seg_p = moved_p.replace(".nii.gz", "_seg.nii.gz")
        segmenter(fx_proc_p, pcfg.fx_contrast, fx_seg_p)
        segmenter(mov_proc_p, pcfg.mov_contrast, mov_seg_p)
        segmenter(moved_p, pcfg.mov_contrast, moved_seg_p)
        _mark("segment")

        used_fallback = False
        if pcfg.opt_affine:
            with _DEVICE_LOCK:
                m = overlap_metrics(
                    nifti.load(fx_seg_p, cached=True).get_fdata(),
                    nifti.load(moved_seg_p, cached=True).get_fdata(), dev,
                )
            if 100 * m["dice"] < pcfg.min_sc_dice:
                # ---- affine fallback (opt_affine.sh:156-182) ----
                used_fallback = True
                if pcfg.affine_fallback_mode == "rigid":
                    field = rigid_affine_field(
                        nifti.load(fx_seg_p, cached=True).get_fdata(),
                        nifti.load(mov_seg_p, cached=True).get_fdata(),
                    )
                else:
                    field = centermass_affine_field(
                        nifti.load(fx_seg_p, cached=True).get_fdata(),
                        nifti.load(mov_seg_p, cached=True).get_fdata(),
                    )
                mov_affine_p = f"{mov_stem}_affine.nii.gz"
                # the centermass field lives on the *processed* grid; align the
                # processed moving volume, then re-register from it
                with _DEVICE_LOCK:
                    apply_affine_field(mov_proc_p, field, mov_affine_p, device=dev,
                                       impl=registrar.impl)
                    out = do_register(mov_affine_p)
                # the re-registration's per-phase timings land under
                # opt_affine.register.* so phase attribution stays correct
                # for fallback subjects (register.* keeps the first call's)
                for k, v in (out.get("timings") or {}).items():
                    timings[f"opt_affine.register.{k}"] = v
                aff_stem = mov_affine_p.split(".")[0]
                moved_p = f"{aff_stem}_proc_reg_to_{pcfg.fx_contrast}.nii.gz"
                warp_p = f"{aff_stem}_proc_field_to_{pcfg.fx_contrast}.nii.gz"
                segmenter(moved_p, pcfg.mov_contrast, moved_seg_p)
            _mark("opt_affine")

        # ---- evaluators → CSVs (sh:142-156) ----
        sub_id = subject
        csv_dir = pcfg.csv_dir if os.path.isabs(pcfg.csv_dir) else os.path.join(path_out, pcfg.csv_dir)
        os.makedirs(csv_dir, exist_ok=True)
        # moved/warp values equal the just-written files (both f32 on disk);
        # in the opt-affine fallback branch `out` was re-assigned alongside
        # moved_p/warp_p, so the arrays always match the paths
        with _DEVICE_LOCK:
            metrics, jac = _evaluate(
                sub_id, fx_seg_p, mov_seg_p, moved_seg_p,
                fx_proc_p, mov_proc_p, moved_p, warp_p, csv_dir,
                moved_arr=np.asarray(out["moved"], np.float32) if out.get("moved") is not None else None,
                warp_arr=out["warp"], device=dev,
            )
        _mark("evaluate")

        # ---- QC (sh:159-164) ----
        if qc is not None:
            # deformation-grid panel (sct_qc registration view, README.md:114):
            # analytic warped-gridline mosaic, host-side (no device round trip)
            grid_mosaic = None
            try:
                proc_shape = nifti.load(moved_p, cached=True).shape[:3]
                grid_mosaic = warped_grid_mosaic(
                    out["warp_data"], out["scale"], proc_shape
                )
            except Exception:
                grid_mosaic = None
            qc.add_subject(
                subject, fx_proc_p, mov_proc_p, moved_p,
                seg_paths={"fixed": fx_seg_p, "moved": moved_seg_p},
                metrics={
                    "dice_after": metrics["dice"],
                    "pct_negative_detJ": jac["percentage_negative_detJa"],
                    "affine_fallback": used_fallback,
                },
                grid_mosaic=grid_mosaic,
            )
            _mark("qc")

        # ---- reorganize outputs (sh:166-221) ----
        # barrier: everything below touches the filesystem directly
        # (shutil.move / os.path.exists), so pending write-behind saves
        # must land first
        nifti.flush_writes()
        final_fx, final_moved = fx_proc_p, moved_p
        if pcfg.reorganize:
            final_fx, final_moved = _reorganize_outputs(
                work, pcfg, fx_p, mov_p, fx_proc_p, moved_p
            )
            _mark("reorganize")

        # ---- output existence check (sh:223-243) ----
        missing = [p for p in (final_fx, final_moved) if not os.path.exists(p)]
        if missing:
            with _ERRLOG_LOCK, open(
                os.path.join(path_out, "_error_check_output_files.log"), "a"
            ) as f:
                for p in missing:
                    f.write(f"{subject}: missing {p}\n")

        return SubjectResult(
            subject, not missing, time.time() - t0,
            metrics={"dice_after": metrics["dice"],
                     "pct_neg_detJ": jac["percentage_negative_detJa"]},
            missing_files=missing, used_affine_fallback=used_fallback,
            timings=timings,
        )
    except Exception as e:  # noqa: BLE001 — per-subject isolation, like set -e per forked shell
        import traceback

        return SubjectResult(subject, False, time.time() - t0, error=traceback.format_exc(limit=5))
