"""Registration quality of the batch pipeline on held-out synthetic subjects.

    python -m multimodal_registration_torch.tools.pipeline_quality [pipeline|twostep|all]
        [--quick] [--subjects N] [--seed S] [--model1-sigma SIGMA] [--out FILE]
        [--keep DIR] [--device cpu]

The port's counterpart of ``benchmarks/pipeline_parity_run.py`` and
``benchmarks/twostep_parity_run.py``, in one module. Each part builds a BIDS
tree of synthetic subjects from label maps that no in-repo model was trained
on (:func:`build_dataset`: two syntheses of one map a subject, T2w and T1w,
with one label brightened as the "spinal cord"), pushes it through
``pipeline/batch.py::run_batch`` (register, segment by threshold, the three
evaluators, QC) and reads the CSVs back (:func:`collect`):

* ``pipeline`` (:func:`pipeline_arms`): maps seed 777, 3 subjects at
  160x160x192, 26 labels, ``--opt-affine`` with ``min_sc_dice`` 80, in three
  arms: ``learned_ref`` (the flagship, ``TrainConfig``'s widths), ``w256``
  (the published widths in bf16) and ``w256_int8`` (the same in int8 with the
  in-repo ``.quant.json`` sidecar);
* ``twostep`` (:func:`twostep_arms`): maps seed 888, each moving contrast
  displaced by a large rigid transform (:func:`displace_moving`), in five
  arms: ``single``, ``opt_affine`` (centermass fallback), ``opt_affine_rigid``
  (rigid fallback), ``two_step`` (``learned_model1`` then ``learned_ref``,
  no step-1 smoothing) and ``two_step_smooth`` (step-1 SVF smoothing sigma 3).

The artifact (``--out``, default a file in a new temporary directory; never
under ``benchmarks/``) has a ``pipeline`` and a ``twostep`` entry whose
``summary`` and ``arms`` keys are those of the JAX package's in-repo
artifacts, plus each arm's s/subject and kernel launches, and the ``gates``:

* every arm ``batch_ok``;
* in each pipeline arm, for every subject: SC-Dice after registration
  >= 0.80 (the JAX gate, ``pipeline_parity_run.py:233``), NMI improvement
  > 0, folding <= 0.1 % of the voxels, and no affine fallback taken;
* int8's mean SC-Dice after at most 0.005 below bf16's (the quantize gate,
  ``benchmarks/quantize_quality_probe.py:16-17``);
* two-step: mean SC-Dice after above the single model's, and the smoothed
  cascade's worst folding at most the raw cascade's.

A failed gate raises :class:`GateFailure` (exit code non-zero). ``--quick``
runs the same code at 48^3, 8 labels, with tiny models (enc/dec [4],
float32, a fresh initialisation) and records the gates without holding them.
The draws come from ``torch.Generator`` streams (maps from the tree's maps
seed, images from ``--seed``), not from JAX's PRNG: the trees follow the JAX
scripts' recipe, not their voxels. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.weights import params_to_jax
from multimodal_registration_torch.pipeline.batch import run_batch
from multimodal_registration_torch.pipeline.segment import ThresholdSegmenter
from multimodal_registration_torch.synth.image_engine import labels_to_image
from multimodal_registration_torch.synth.labelmaps import generate_label_maps
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer
from multimodal_registration_torch.utils import nifti

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCHMARKS = os.path.join(ROOT, "benchmarks")
CKPT_REF = os.path.join(BENCHMARKS, "learned_ref_160x160x192_26lab.npz")
CKPT_W256 = os.path.join(BENCHMARKS, "learned_w256_160x160x192_26lab.npz")
CKPT_MODEL1 = os.path.join(BENCHMARKS, "learned_model1_160x160x192_26lab.npz")

SHAPE, NUM_LABELS = (160, 160, 192), 26
QUICK_SHAPE, QUICK_LABELS = (48, 48, 48), 8
PIPELINE_MAPS_SEED, TWOSTEP_MAPS_SEED, DISPLACE_SEED_BASE = 777, 888, 500
CORD_FRACTION = 0.015   # the cord label: voxel count closest to this share
CORD_DOMINANCE = 2.0    # and its largest connected piece this many times the next
SEGMENT_PERCENTILE = 98.4
MIN_SC_DICE = 80        # percent, the opt-affine gate
MODEL1_SIGMA = 3.0      # step-1 SVF smoothing of the two_step_smooth arm
GATE_SC_DICE = 0.80
GATE_FOLDING_PERCENT = 0.1
GATE_INT8_DICE_GAP = 0.005
PIPELINE_ARMS = ("learned_ref", "w256", "w256_int8")
TWOSTEP_ARMS = {  # arm: (step-1 model, step-2 model, opt-affine gate, smoothed config)
    "single": ("fine", None, False, False),
    "opt_affine": ("fine", None, True, False),
    "opt_affine_rigid": ("fine", None, "rigid", False),
    "two_step": ("smooth", "fine", False, False),
    "two_step_smooth": ("smooth", "fine", False, True),
}
CSVS = ("metrics_on_sc_seg.csv", "nmi.csv", "jacobian_det.csv")


class GateFailure(RuntimeError):
    """A quality gate of the tool failed."""


def train_config(quick: bool, width: int | None = None) -> TrainConfig:
    """The synthesis (and, with ``width``, the model) configuration of a run."""
    if quick:
        return TrainConfig.from_dict(dict(
            in_shape=list(QUICK_SHAPE), num_labels=QUICK_LABELS, num_maps=2, im_scales=[8],
            def_scales=[8], enc=[4] * 4, dec=[4] * 6, compute_dtype="float32", epochs=1))
    d = dict(in_shape=list(SHAPE), num_labels=NUM_LABELS, num_maps=2, batch_size=1, epochs=1)
    if width:
        d.update(enc=[width] * 4, dec=[width] * 6)
    return TrainConfig.from_dict(d)


def inference_config(tcfg: TrainConfig, quick: bool) -> dict:
    """The inference config that matches ``tcfg``'s checkpoint
    (``pipeline_parity_run.py:143-160``)."""
    if quick:
        return dict(enc=[4] * 4, dec=[4] * 6, compute_dtype="float32")
    return dict(enc=list(tcfg.enc), dec=list(tcfg.dec), int_steps=tcfg.int_steps,
                int_res=tcfg.int_res, svf_res=tcfg.svf_res)


def cord_label(lab: np.ndarray, num_labels: int) -> int:
    """The synthetic cord of label map ``lab``: of the labels 1..L-1, taken
    in the order of their voxel counts' distance to 1.5 % of the volume, the
    first whose largest connected piece (6-connected) holds at least
    ``CORD_DOMINANCE`` times the voxels of its next largest. The JAX scripts
    take the closest count alone; but the threshold segmenter keeps the
    largest bright component, so a label of two pieces of about the same
    size is segmented as one piece in one synthesis and as the other in the
    next: SC-Dice 0 before and after registration, whatever the
    registration."""
    from scipy import ndimage

    counts = np.bincount(lab.ravel(), minlength=num_labels)
    for label in np.argsort(np.abs(counts[1:] - CORD_FRACTION * lab.size), kind="stable") + 1:
        pieces, n = ndimage.label(lab == label)
        sizes = np.sort(np.bincount(pieces.ravel())[1:])[::-1]
        if n and (n == 1 or sizes[0] >= CORD_DOMINANCE * sizes[1]):
            return int(label)
    raise ValueError(f"no label of the map has a piece {CORD_DOMINANCE} times its next")


@torch.no_grad()
def build_dataset(root: str, shape, num_labels: int, n_subjects: int, engine_cfg, scales,
                  maps_seed: int, gen: torch.Generator, device) -> list:
    """Write ``n_subjects`` held-out subjects ``sub-XX/anat/sub-XX_{T2w,T1w}.nii.gz``
    (identity affine) under ``root``; returns their names.

    The label maps are drawn on ``device`` from a generator seeded with
    ``maps_seed`` (``synth/labelmaps.py``, Perlin ``scales`` = ``(im_scales,
    def_scales)``), each contrast synthesised from its subject's map by the
    image engine (``labels_to_image``, kernel K6 on the card) with ``gen``.
    The "cord" is the label whose voxel count is closest to 1.5 % of the
    volume among those of one dominant piece (:func:`cord_label`); its mask,
    taken from each image's own warped labels (the argmax of the soft
    one-hot) and blurred with a Gaussian of sigma 1, brightens the image:
    ``0.5 * image + mask``. So the background stays at most 0.5 and the
    cord's interior reaches about 1.0 in both contrasts, which the threshold
    segmenter separates (``pipeline_parity_run.py:45-90``)."""
    from scipy import ndimage

    dev = resolve_device(device)
    maps = generate_label_maps(torch.Generator(device=dev).manual_seed(int(maps_seed)),
                               n_subjects, tuple(shape), num_labels, device=dev,
                               im_scales=scales[0], def_scales=scales[1])
    subjects = []
    for i, lab in enumerate(maps):
        sub = f"sub-{i + 1:02d}"
        cord = cord_label(lab, num_labels)
        anat = os.path.join(root, sub, "anat")
        os.makedirs(anat, exist_ok=True)
        lab_t = torch.as_tensor(lab, device=dev)
        for contrast in ("T2w", "T1w"):
            img, onehot = labels_to_image(lab_t, engine_cfg, gen=gen)
            warped_lab = onehot.argmax(-1).cpu().numpy()
            mask = ndimage.gaussian_filter((warped_lab == cord).astype(np.float32), 1.0)
            img = 0.5 * img.float().cpu().numpy() + 1.0 * mask
            nifti.save(nifti.NiftiImage(img.astype(np.float32), np.eye(4)),
                       os.path.join(anat, f"{sub}_{contrast}.nii.gz"))
        subjects.append(sub)
    return subjects


def rigid_displace(img, lab, seed):
    """Host-side large rigid displacement of a (vol, labels) pair — the
    held-out 'affine regime' probe. scipy affine_transform maps OUTPUT
    coords through the matrix, which is exactly the moving-volume
    resampling an acquisition-space mismatch produces."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    ang = np.deg2rad(rng.uniform(-6, 6))
    axis = rng.integers(3)
    rot = np.eye(3)
    i, j = [a for a in range(3) if a != axis]
    rot[i, i] = rot[j, j] = np.cos(ang)
    rot[i, j], rot[j, i] = -np.sin(ang), np.sin(ang)
    shift = rng.uniform(-12, 12, size=3)
    center = (np.asarray(img.shape) - 1) / 2.0
    offset = center - rot @ center + shift
    mov = ndimage.affine_transform(img, rot, offset=offset, order=1)
    mov_lab = ndimage.affine_transform(lab, rot, offset=offset, order=0)
    return mov.astype(np.float32), mov_lab


def displace_moving(root, subjects, seed_base=DISPLACE_SEED_BASE):
    """Apply a large random rigid transform to each subject's moving (T1w)
    contrast in place — the 'initially in different affine spaces' setting."""
    for s, sub in enumerate(subjects):
        p = os.path.join(root, sub, "anat", f"{sub}_T1w.nii.gz")
        im = nifti.load(p)
        data = np.asarray(im.get_fdata(np.float32))
        lab = np.zeros_like(data)  # labels unused; rigid_displace needs a pair
        mov, _ = rigid_displace(data, lab, seed_base + s)
        nifti.save(nifti.NiftiImage(mov, im.affine), p)


def collect(out, subjects):
    """The last row of each subject in the arm's ``metrics_on_sc_seg.csv``,
    ``nmi.csv`` and ``jacobian_det.csv``, searched in this arm's output tree
    only (``twostep_parity_run.py:65-104``)."""

    def rows(path):
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return list(csv.DictReader(f))

    found = {}
    for name in CSVS:
        for c in (os.path.join(out, "log"), out, os.path.join(out, "data_processed")):
            p = os.path.join(c, name)
            if os.path.exists(p):
                found[name] = p
                break

    sc_rows = rows(found.get("metrics_on_sc_seg.csv", ""))
    nmi_rows = rows(found.get("nmi.csv", ""))
    jac_rows = rows(found.get("jacobian_det.csv", ""))

    def last_for(rws, sub):
        hits = [r for r in rws if r.get("Subject") == sub]
        return hits[-1] if hits else {}

    per, dices, gains, folds = [], [], [], []
    for sub in subjects:
        sc, mi, ja = (last_for(r, sub) for r in (sc_rows, nmi_rows, jac_rows))
        per.append({"subject": sub, "sc": sc, "nmi": mi, "jacobian": ja})
        if sc:
            dices.append((round(float(sc["Dice_before_registration"]), 4),
                          round(float(sc["Dice_after_registration"]), 4)))
        if mi:
            gains.append(float(mi["Percentage_nmi_improvement_registration"]))
        if ja:
            folds.append(float(ja["Percentage_negative_detJa[%]"]))
    return {"per_subject": per, "dice_before_after": dices,
            "nmi_percent_improvement": gains, "folding_percent": folds}


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernels.launch_counts().items()}


def run_arm(data: str, out: str, subjects: list, model_path: str, config_path: str,
            model2_path: str | None = None, gate=False, device=None) -> dict:
    """One ``run_batch`` over ``data`` into ``out``: :func:`collect`'s lists,
    ``batch_ok``, the fallback subjects, ``batch_summary``, s/subject (the
    batch's own clock, the registrar built before) and the kernel launches
    it made. ``gate``: ``False``, ``True`` (opt-affine,
    centermass) or ``"rigid"``."""
    kw = dict(opt_affine=bool(gate))
    if gate:
        kw["min_sc_dice"] = MIN_SC_DICE
    if gate == "rigid":
        kw["affine_fallback_mode"] = "rigid"
    before = kernels.launch_counts()
    results, summary = run_batch(
        path_data=data, path_output=out, model_path=model_path, config_path=config_path,
        model2_path=model2_path, jobs=1,
        # top ~1.6% of voxels ~= the cord the dataset builder brightens
        segmenter=ThresholdSegmenter(percentile=SEGMENT_PERCENTILE), device=device, **kw)
    arm = collect(out, subjects)
    arm.update(
        batch_ok=all(r.ok for r in results) and len(results) == len(subjects),
        used_affine_fallback=[r.subject for r in results if r.used_affine_fallback],
        batch_summary=summary,
        s_per_subject=summary["total_seconds"] / max(1, len(results)),
        launches=_launches_since(before),
        errors={r.subject: r.error for r in results if not r.ok})
    return arm


def _write_config(path: str, cfg: dict) -> str:
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _quick_weights(root: str, tcfg: TrainConfig) -> str:
    """A freshly initialised tiny model (the JAX package's init scheme) as a
    flat ``.npz``: the ``--quick`` runs' checkpoint for every arm."""
    path = os.path.join(root, "w_quick.npz")
    trainer = Trainer(tcfg, device="cpu")
    np.savez(path, **params_to_jax(trainer.model.state_dict()))
    return path


def _private_checkpoint(path: str, root: str) -> str:
    """``path`` linked into ``root`` with a copy of its ``.quant.json``
    sidecar, if any: a lazy int8 calibration then writes its sidecar there,
    never beside the in-repo checkpoint."""
    os.makedirs(root, exist_ok=True)
    link = os.path.join(root, os.path.basename(path))
    if not os.path.exists(link):
        os.symlink(os.path.abspath(path), link)
    if os.path.exists(path + ".quant.json"):
        shutil.copy(path + ".quant.json", link + ".quant.json")
    return link


def _check_checkpoints(*paths):
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"missing checkpoint {p}")


def _engine(quick: bool, device):
    tcfg = train_config(quick)
    return Trainer(tcfg, device=device).engine_cfg, (tcfg.im_scales, tcfg.def_scales), tcfg


def pipeline_arm_specs(quick: bool, root: str) -> dict:
    """``{arm: (checkpoint, inference config)}`` of the three pipeline arms."""
    if quick:
        tcfg = train_config(True)
        w = _quick_weights(root, tcfg)
        cfg = inference_config(tcfg, True)
        return {"learned_ref": (w, cfg), "w256": (w, cfg),
                "w256_int8": (w, dict(cfg, quantize="int8"))}
    _check_checkpoints(CKPT_REF, CKPT_W256)
    w256 = inference_config(train_config(False, 256), False)
    return {"learned_ref": (CKPT_REF, inference_config(train_config(False), False)),
            "w256": (CKPT_W256, w256),
            "w256_int8": (_private_checkpoint(CKPT_W256, os.path.join(root, "int8")),
                          dict(w256, quantize="int8"))}


def _print_arm(part: str, name: str, arm: dict, dev) -> None:
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[{part}/{name}] {arm['s_per_subject']:.3f} s/subject ({where}); "
          f"SC-Dice before/after {arm['dice_before_after']}, NMI gain % "
          f"{arm['nmi_percent_improvement']}, folding % {arm['folding_percent']}, "
          f"fallback {arm['used_affine_fallback']}, batch_ok {arm['batch_ok']}", flush=True)


def pipeline_arms(root: str, device=None, quick: bool = False, n_subjects: int = 3,
                  seed: int = 0) -> dict:
    """The three pipeline arms on one tree (maps seed 777) built under
    ``root``; their outputs stay in ``root/out_<arm>``. Returns the part's
    artifact: ``arms`` (each with the JAX artifact's keys, ``summary``
    among them), ``synthesis_launches``."""
    dev = resolve_device(device)
    shape = QUICK_SHAPE if quick else SHAPE
    num_labels = QUICK_LABELS if quick else NUM_LABELS
    os.makedirs(root, exist_ok=True)
    specs = pipeline_arm_specs(quick, root)
    engine_cfg, scales, _ = _engine(quick, dev)
    data = os.path.join(root, "data")
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    subjects = build_dataset(data, shape, num_labels, n_subjects, engine_cfg, scales,
                             PIPELINE_MAPS_SEED, torch.Generator(device=dev).manual_seed(seed),
                             dev)
    synthesis = {"seconds": time.perf_counter() - t0, "launches": _launches_since(before)}
    arms = {}
    for name, (model, cfg) in specs.items():
        cfg_path = _write_config(os.path.join(root, f"cfg_{name}.json"), cfg)
        arm = run_arm(data, os.path.join(root, f"out_{name}"), subjects, model, cfg_path,
                      gate=True, device=dev)
        dices = arm.pop("dice_before_after")
        summary = {
            "sc_dice_gate_80_passed": bool(dices) and all(a >= GATE_SC_DICE for _, a in dices),
            "dice_before_after": dices,
            "folding_percent": arm.pop("folding_percent"),
            "nmi_percent_improvement": arm.pop("nmi_percent_improvement"),
        }
        arms[name] = {"checkpoint": os.path.basename(model), "model_path": model, "config": cfg,
                      "workload": f"{shape} / {num_labels} labels", "subjects": subjects,
                      **arm, "summary": summary}
        _print_arm("pipeline", name, {**arm, **summary}, dev)
    return {"workload": f"{shape} / {num_labels} labels", "subjects": subjects,
            "maps_seed": PIPELINE_MAPS_SEED, "seed": seed, "quick": quick,
            "synthesis": synthesis, "arms": arms}


def twostep_arms(root: str, device=None, quick: bool = False, n_subjects: int = 3,
                 seed: int = 0, model1_sigma: float = MODEL1_SIGMA) -> dict:
    """The five two-step arms on a second tree (maps seed 888, the moving
    contrast rigidly displaced) built under ``root``; outputs in
    ``root/out_<arm>``. Returns the part's artifact with the JAX artifact's
    ``summary`` and ``arms`` keys (``twostep_parity_run.py:108-248``)."""
    dev = resolve_device(device)
    shape = QUICK_SHAPE if quick else SHAPE
    num_labels = QUICK_LABELS if quick else NUM_LABELS
    os.makedirs(root, exist_ok=True)
    engine_cfg, scales, tcfg = _engine(quick, dev)
    if quick:
        fine = smooth = _quick_weights(root, tcfg)
    else:
        fine, smooth = CKPT_REF, CKPT_MODEL1
        _check_checkpoints(fine, smooth)
    models = {"fine": fine, "smooth": smooth}
    infer_cfg = inference_config(tcfg, quick)
    data = os.path.join(root, "data")
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    subjects = build_dataset(data, shape, num_labels, n_subjects, engine_cfg, scales,
                             TWOSTEP_MAPS_SEED, torch.Generator(device=dev).manual_seed(seed),
                             dev)
    displace_moving(data, subjects)
    synthesis = {"seconds": time.perf_counter() - t0, "launches": _launches_since(before)}
    # the raw config pins the reference's compose semantics (no step-1
    # smoothing, whatever the shipped default is)
    cfg_path = _write_config(os.path.join(root, "cfg_inference.json"),
                             {**infer_cfg, "model1_svf_smooth_sigma": 0.0})
    cfg_smooth_path = _write_config(os.path.join(root, "cfg_inference_smooth.json"),
                                    {**infer_cfg, "model1_svf_smooth_sigma": model1_sigma})
    arms = {}
    for name, (m1, m2, gate, smoothed) in TWOSTEP_ARMS.items():
        arms[name] = run_arm(data, os.path.join(root, f"out_{name}"), subjects, models[m1],
                             cfg_smooth_path if smoothed else cfg_path,
                             model2_path=models[m2] if m2 else None, gate=gate, device=dev)
        _print_arm("twostep", name, arms[name], dev)

    def mean_after(arm):
        d = arms[arm]["dice_before_after"]
        return round(float(np.mean([a for _, a in d])), 4) if d else None

    def worst(arm):
        f = arms[arm]["folding_percent"]
        return max(f) if f else None

    single, two = mean_after("single"), mean_after("two_step")
    return {
        "checkpoints": {"model1": os.path.basename(smooth), "model2": os.path.basename(fine)},
        "workload": f"{shape} / {num_labels} labels, rigid-displaced moving",
        "subjects": subjects, "maps_seed": TWOSTEP_MAPS_SEED, "seed": seed, "quick": quick,
        "synthesis": synthesis,
        "arms": arms,
        "model1_svf_smooth_sigma": model1_sigma,
        "summary": {
            **{f"sc_dice_after_{a}": mean_after(a) for a in TWOSTEP_ARMS},
            "two_step_minus_single": (round(two - single, 4)
                                      if single is not None and two is not None else None),
            "worst_folding_two_step": worst("two_step"),
            "worst_folding_two_step_smooth": worst("two_step_smooth"),
        },
    }


def gates(pipeline: dict | None = None, twostep: dict | None = None) -> dict:
    """Each gate's name and whether it held (module docstring). A subject
    without a CSV row fails the gates that read that row."""
    g = {}
    if pipeline is not None:
        n = len(pipeline["subjects"])
        for name, arm in pipeline["arms"].items():
            s = arm["summary"]
            dices = s["dice_before_after"]
            g[f"pipeline/{name}: batch_ok"] = bool(arm["batch_ok"])
            g[f"pipeline/{name}: SC-Dice after >= {GATE_SC_DICE} for every subject"] = (
                len(dices) == n and all(a >= GATE_SC_DICE for _, a in dices))
            g[f"pipeline/{name}: NMI gain > 0 for every subject"] = (
                len(s["nmi_percent_improvement"]) == n
                and all(v > 0 for v in s["nmi_percent_improvement"]))
            g[f"pipeline/{name}: folding <= {GATE_FOLDING_PERCENT} % for every subject"] = (
                len(s["folding_percent"]) == n
                and all(v <= GATE_FOLDING_PERCENT for v in s["folding_percent"]))
            g[f"pipeline/{name}: no affine fallback"] = not arm["used_affine_fallback"]
        arms = pipeline["arms"]
        if "w256" in arms and "w256_int8" in arms:
            bf16 = [a for _, a in arms["w256"]["summary"]["dice_before_after"]]
            int8 = [a for _, a in arms["w256_int8"]["summary"]["dice_before_after"]]
            g[f"pipeline: int8 mean SC-Dice after within {GATE_INT8_DICE_GAP} of bf16's"] = (
                len(bf16) == len(int8) == n
                and float(np.mean(int8)) >= float(np.mean(bf16)) - GATE_INT8_DICE_GAP)
    if twostep is not None:
        for name, arm in twostep["arms"].items():
            g[f"twostep/{name}: batch_ok"] = bool(arm["batch_ok"])
        s = twostep["summary"]
        single, two = s["sc_dice_after_single"], s["sc_dice_after_two_step"]
        raw, smooth = s["worst_folding_two_step"], s["worst_folding_two_step_smooth"]
        g["twostep: two_step SC-Dice after > single"] = (
            single is not None and two is not None and two > single)
        g["twostep: worst folding two_step_smooth <= two_step"] = (
            raw is not None and smooth is not None and smooth <= raw)
    return g


def run(part: str = "all", device=None, quick: bool = False, n_subjects: int = 3,
        seed: int = 0, model1_sigma: float = MODEL1_SIGMA, root: str | None = None) -> dict:
    """Run the chosen part(s) under ``root`` (default: a new temporary
    directory, removed after) and return the artifact with its gates."""
    dev = resolve_device(device)
    own = root is None
    root = root or tempfile.mkdtemp(prefix="pipeline_quality_")
    try:
        art = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "torch": torch.__version__, "cuda": torch.version.cuda}
        if part in ("pipeline", "all"):
            art["pipeline"] = pipeline_arms(os.path.join(root, "pipeline"), dev, quick,
                                            n_subjects, seed)
        if part in ("twostep", "all"):
            art["twostep"] = twostep_arms(os.path.join(root, "twostep"), dev, quick,
                                          n_subjects, seed, model1_sigma)
        art["gates"] = gates(art.get("pipeline"), art.get("twostep"))
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
    return art


def _out_path(out: str | None) -> str:
    path = os.path.abspath(out or os.path.join(tempfile.mkdtemp(prefix="pipeline_quality_"),
                                               "pipeline_quality.json"))
    if os.path.commonpath([path, BENCHMARKS]) == BENCHMARKS:
        raise ValueError(f"--out {path}: the tool never writes under {BENCHMARKS}")
    return path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Registration quality of the batch pipeline on "
                                            "held-out synthetic subjects (the JAX parity runs).")
    p.add_argument("part", nargs="?", default="all", choices=("pipeline", "twostep", "all"))
    p.add_argument("--quick", action="store_true",
                   help="48^3, 8 labels, tiny models, gates recorded but not held")
    p.add_argument("--subjects", type=int, default=3)
    p.add_argument("--seed", type=int, default=0, help="seed of the image syntheses")
    p.add_argument("--model1-sigma", type=float, default=MODEL1_SIGMA,
                   help="step-1 SVF smoothing sigma of the two_step_smooth arm")
    p.add_argument("--out", default=None, help="artifact JSON file (default: a temp directory)")
    p.add_argument("--keep", default=None, help="keep the trees and outputs under this directory")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    out = _out_path(a.out)
    art = run(a.part, a.device, a.quick, a.subjects, a.seed, a.model1_sigma, a.keep)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(art, f, indent=1, default=str)
    for part in ("pipeline", "twostep"):
        if part in art:
            summary = (art[part]["summary"] if part == "twostep" else
                       {k: v["summary"] for k, v in art[part]["arms"].items()})
            print(f"{part} summary: {json.dumps(summary)}", flush=True)
    print(f"gates: {json.dumps(art['gates'])}", flush=True)
    print(f"artifact: {out}", flush=True)
    failed = [k for k, ok in art["gates"].items() if not ok]
    if failed and not a.quick:
        raise GateFailure(f"quality gates failed: {failed}")
    return art


if __name__ == "__main__":
    main()
