"""End-to-end batch-pipeline throughput and its attribution by phase.

    python -m multimodal_registration_torch.tools.pipeline_throughput [--quick]
        [--subjects 4] [--configs default,noprefetch,jobs2[,jobs4]]
        [--dataset-dir DIR] [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/pipeline_throughput.py``: a synthetic
BIDS dataset of ``--subjects`` subjects at 160x160x192, 26 labels
(``tools/pipeline_quality.py::build_dataset``, label maps from seed 4242,
T2w and T1w synthesised from each by the image engine) goes through the
whole production path, ``pipeline/batch.py::run_batch`` (register on
``learned_ref_160x160x192_26lab.npz``, segment by threshold, the three
evaluators, QC, reorganise), once for each configuration:

* ``default``: one job, the native prefetch, write-behind saves;
* ``noprefetch``: the same with ``MMREG_NO_PREFETCH=1``;
* ``jobs2`` / ``jobs4``: two or four subjects at a time.

For each: ``ok`` (every subject), ``wall_s`` (the call, the registrar built
inside it), ``subjects_per_min``, ``subjects_per_min_steady`` (all subjects
but the first, from their own seconds), ``per_subject_s`` and
``phase_totals_s`` (the subjects' ``timings`` summed). ``--dataset-dir``
keeps the dataset and reuses it on a later run. ``--quick``: 48^3, 8 labels,
a tiny float32 model (enc/dec [4], a fresh initialisation). One line a
configuration, then the whole document, which ``--out`` also receives (never
under ``benchmarks/``). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.pipeline.batch import run_batch
from multimodal_registration_torch.pipeline.segment import ThresholdSegmenter
from multimodal_registration_torch.tools import pipeline_quality as pq
from multimodal_registration_torch.tools.timing import card_note, note, write_result
from multimodal_registration_torch.train.trainer import engine_config_from

MAPS_SEED = 4242
MODES = {
    "default": dict(jobs=1),
    "noprefetch": dict(jobs=1, _noprefetch=True),
    "jobs2": dict(jobs=2),
    "jobs4": dict(jobs=4),
}


def phase_totals(results) -> dict:
    tot = {}
    for r in results:
        for k, v in (r.timings or {}).items():
            tot[k] = tot.get(k, 0.0) + v
    return tot


def dataset(data: str, n_subjects: int, quick: bool, dev, reuse: bool) -> tuple:
    """Build (or, with ``reuse``, find) the dataset under ``data``:
    ``(subjects, build seconds)``."""
    tcfg = pq.train_config(quick)
    shape = tuple(tcfg.in_shape)
    marker = os.path.join(data, f".built_{shape[0]}x{shape[2]}_{n_subjects}")
    if reuse and os.path.exists(marker):
        return sorted(d for d in os.listdir(data) if d.startswith("sub-"))[:n_subjects], 0.0
    t0 = time.perf_counter()
    subjects = pq.build_dataset(data, shape, tcfg.num_labels, n_subjects,
                                engine_config_from(tcfg), (tcfg.im_scales, tcfg.def_scales),
                                MAPS_SEED, torch.Generator(device=dev).manual_seed(0), dev)
    open(marker, "w").close()
    return subjects, time.perf_counter() - t0


def run_config(name: str, data: str, out: str, model_path: str, cfg_path: str, dev) -> dict:
    """One ``run_batch`` of configuration ``name``; its record."""
    kw = dict(MODES[name])
    noprefetch = kw.pop("_noprefetch", False)
    if noprefetch:
        os.environ["MMREG_NO_PREFETCH"] = "1"
    try:
        t0 = time.perf_counter()
        results, _ = run_batch(path_data=data, path_output=out, model_path=model_path,
                               config_path=cfg_path,
                               segmenter=ThresholdSegmenter(percentile=pq.SEGMENT_PERCENTILE),
                               device=dev, **kw)
        wall = time.perf_counter() - t0
    finally:
        if noprefetch:
            os.environ.pop("MMREG_NO_PREFETCH", None)
    # the first subject pays the first launches and cuDNN's choices; the
    # steady rate counts the others, from their own seconds
    per = [r.seconds for r in results]
    steady = (len(per) - 1) / max(sum(per[1:]), 1e-9) * 60 if len(per) > 1 else None
    return {"ok": bool(results) and all(r.ok for r in results), "wall_s": wall,
            "subjects_per_min": len(results) / wall * 60, "subjects_per_min_steady": steady,
            "per_subject_s": per, "phase_totals_s": phase_totals(results)}


def run(configs=("default", "noprefetch", "jobs2"), n_subjects: int = 4, quick: bool = False,
        dataset_dir: str | None = None, device=None, emit=print) -> dict:
    """Build the dataset, run each configuration; returns the document."""
    dev = resolve_device(device)
    unknown = [c for c in configs if c not in MODES]
    if unknown:
        raise ValueError(f"unknown configurations {unknown}: choose from {sorted(MODES)}")
    root = tempfile.mkdtemp(prefix="ppl_bench_")
    try:
        tcfg = pq.train_config(quick)
        if quick:
            model_path = pq._quick_weights(root, tcfg)
        else:
            pq._check_checkpoints(pq.CKPT_REF)
            model_path = pq.CKPT_REF
        data = dataset_dir or os.path.join(root, "data")
        subjects, t_build = dataset(data, n_subjects, quick, dev, reuse=bool(dataset_dir))
        cfg_path = pq._write_config(os.path.join(root, "cfg_inference.json"),
                                    pq.inference_config(tcfg, quick))
        doc = {"workload": f"{tuple(tcfg.in_shape)} / {tcfg.num_labels} labels",
               "n_subjects": len(subjects), "dataset_build_s": t_build, "configs": {}}
        for name in configs:
            doc["configs"][name] = run_config(name, data, os.path.join(root, f"out_{name}"),
                                              model_path, cfg_path, dev)
            emit(f"{name} {json.dumps(doc['configs'][name])}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(json.dumps(doc, indent=1))
    return doc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="tiny run: 48^3, 8 labels, enc/dec 4")
    ap.add_argument("--subjects", type=int, default=4)
    ap.add_argument("--configs", default="default,noprefetch,jobs2",
                    help="comma list: default | noprefetch | jobs2 | jobs4")
    ap.add_argument("--dataset-dir", default="",
                    help="persistent dataset directory: built once, reused on re-runs")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the document to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    configs = [c.strip() for c in a.configs.split(",") if c.strip()]
    doc = run(configs, a.subjects, a.quick, a.dataset_dir or None, dev)
    write_result(a.out, doc)
    return doc


if __name__ == "__main__":
    main()
