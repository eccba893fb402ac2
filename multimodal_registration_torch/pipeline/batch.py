"""Multi-subject batch runner (the ``sct_run_batch`` replacement), the port's
copy of ``multimodal_registration_tpu/pipeline/batch.py``:

    python -m multimodal_registration_torch pipeline --path-data DATA \\
        --path-output OUT --model-path w.npz [--config-path cfg.json] \\
        [--model2-path w2.npz] [--opt-affine] [--space N] [--data-shard N] \\
        [--device cpu]

Parity target: ``sct_run_batch -jobs N -path-data … -path-output … -script …``
(`README.md:128-132`): subject discovery, provisioning of output/QC/log
directories, per-subject execution with per-subject logs, a wall-clock report
per subject (`pipeline_bids_register_evaluate.sh:245-253`), and an error log
for missing outputs.

Design: the reference forks one shell (and one TF runtime) per subject; here
subjects stream through one process that holds the model on the GPU. Part
of the host's work is hidden: write-behind saves (``utils/nifti.py``)
compress and write a subject's outputs while the runner segments, evaluates
and QCs it, and the native prefetch pool (``utils/native.py``) decodes the
next subjects' volumes.
``jobs`` runs subjects on a thread pool for host work (segmentation, NIfTI
I/O, QC) while device work stays serialized (``pipeline/runner.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import load_params_any
from multimodal_registration_torch.infer.sharded import make_registrar
from multimodal_registration_torch.models.quantize import sidecar_kwargs
from multimodal_registration_torch.pipeline.bids import discover_subjects, subject_images
from multimodal_registration_torch.pipeline.qc import QCReport
from multimodal_registration_torch.pipeline.runner import PipelineConfig, run_subject
from multimodal_registration_torch.pipeline.segment import default_segmenter
from multimodal_registration_torch.utils import nifti


def filter_subjects(subjects, include=None, exclude=None,
                    include_list=None, exclude_list=None):
    """``sct_run_batch`` subject-selection parity (`README.md:128-132`):
    ``-include``/``-exclude`` are regex/substring patterns, ``-include-list``/
    ``-exclude-list`` are exact subject names (sub-IDs or full subject paths)."""
    import re

    def _exact(s, names):
        base = s.split("/")[0]
        return s in names or base in names

    if include:
        subjects = [s for s in subjects if any(re.search(i, s) for i in include)]
    if exclude:
        subjects = [s for s in subjects if not any(re.search(x, s) for x in exclude)]
    if include_list:
        subjects = [s for s in subjects if _exact(s, set(include_list))]
    if exclude_list:
        subjects = [s for s in subjects if not _exact(s, set(exclude_list))]
    return subjects


def provision(path_output: str) -> tuple:
    """Create ``path_output`` and its ``data_processed``, ``qc`` and ``log``
    directories; return the three."""
    dirs = tuple(os.path.join(path_output, d) for d in ("data_processed", "qc", "log"))
    for p in dirs:
        os.makedirs(p, exist_ok=True)
    return dirs


def write_subject_log(path_log: str, res) -> None:
    """``log/<subject>.log``: the subject's :class:`SubjectResult` as JSON."""
    with open(os.path.join(path_log, f"{res.subject.replace('/', '_')}.log"), "w") as f:
        f.write(json.dumps(res.__dict__, default=str, indent=2))


def write_summary(path_output: str, results, total_seconds: float) -> dict:
    """``batch_summary.json``: counts and the wall time of each subject."""
    summary = {
        "n_subjects": len(results),
        "n_ok": sum(r.ok for r in results),
        "n_affine_fallback": sum(r.used_affine_fallback for r in results),
        "total_seconds": total_seconds,
        "per_subject_seconds": {r.subject: r.seconds for r in results},
    }
    with open(os.path.join(path_output, "batch_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def run_batch(
    path_data: str,
    path_output: str,
    model_path: str,
    config_path: str | None = None,
    model2_path: str | None = None,
    jobs: int = 1,
    include: list | None = None,
    exclude: list | None = None,
    include_list: list | None = None,
    exclude_list: list | None = None,
    segmenter=None,
    sharding=None,
    device=None,
    **pipeline_kwargs,
):
    """Register and evaluate every (selected) subject of the BIDS dataset
    ``path_data`` into ``path_output`` on ``device`` (default: the GPU);
    returns ``(results, summary)``. ``pipeline_kwargs`` are
    :class:`PipelineConfig` fields; ``sharding`` (``{"data": N, "space":
    M}``, None entries ignored) overrides the config's, and a layout of more
    than one device registers on a mesh of the devices ``device`` offers
    (``infer/sharded.py::make_registrar``)."""
    # pipeline stages read just-written volumes again: prime the decoded-file
    # cache on save, and let the gzip and disk work of a subject's saves run
    # behind its later stages (readers are served from the pending-content
    # map; the runner flushes before reorganizing)
    nifti.enable_save_prime()
    nifti.enable_async_writes()
    try:
        return _run_batch_inner(
            path_data, path_output, model_path, config_path, model2_path,
            jobs, include, exclude, include_list, exclude_list, segmenter,
            sharding, device, pipeline_kwargs,
        )
    finally:
        # write-behind is scoped to this run: later code (e.g. a directory
        # scan) must see synchronous saves
        nifti.disable_async_writes()


def _run_batch_inner(
    path_data, path_output, model_path, config_path, model2_path,
    jobs, include, exclude, include_list, exclude_list, segmenter,
    sharding, device, pipeline_kwargs,
):
    cfg = InferenceConfig.from_json(config_path) if config_path else InferenceConfig()
    if sharding:
        cfg.sharding = {**cfg.sharding, **{k: v for k, v in sharding.items() if v}}
    pcfg = PipelineConfig(**pipeline_kwargs)
    pcfg.two_step = model2_path is not None
    path_processed, path_qc, path_log = provision(path_output)

    # in two-step mode `model_path` is the cascade's step-1 (smooth) model:
    # it takes the model1-specific SVF-smoothing override
    registrar = make_registrar(
        cfg, load_params_any(model_path, cfg),
        svf_smooth_sigma=cfg.model1_svf_smooth_sigma if model2_path else None,
        device=device, **sidecar_kwargs(model_path, cfg),
    )
    registrar2 = make_registrar(
        cfg, load_params_any(model2_path, cfg), device=device,
        **sidecar_kwargs(model2_path, cfg),
    ) if model2_path else None
    segmenter = segmenter or default_segmenter()
    qc = QCReport(path_qc)

    subjects = discover_subjects(path_data)
    subjects = filter_subjects(subjects, include, exclude, include_list, exclude_list)

    t_start = time.time()

    # native prefetch pool: decode the next subjects' volumes while the
    # device works. Submission rides a bounded sliding window: decoded f32
    # volumes are tens of MB each, and a whole dataset submitted up front
    # would sit in the pool's done-map while the consumer lags.
    prefetch = None
    tickets = {}
    _pf_lock = threading.Lock()
    _pf_iter = iter(subjects)
    _pf_window = max(2, 2 * max(jobs, 1))
    _pf_outstanding = [0]
    # MMREG_NO_PREFETCH is a deliberate A/B switch, kept out of the try so it
    # is not mistaken for the library failing to build
    if not os.environ.get("MMREG_NO_PREFETCH"):
        from multimodal_registration_torch.utils.native import PrefetchPool

        try:
            prefetch = PrefetchPool(n_threads=max(jobs, 2))
        except RuntimeError:  # the library did not build (get_lib said why)
            prefetch = None

    def _pf_top_up():
        if prefetch is None:
            return
        with _pf_lock:
            while _pf_outstanding[0] < _pf_window:
                s = next(_pf_iter, None)
                if s is None:
                    return
                files = subject_images(path_data, s).files
                tickets[s] = {
                    c: prefetch.submit(p)
                    for c, p in files.items()
                    if c in (pcfg.fx_contrast, pcfg.mov_contrast)
                }
                _pf_outstanding[0] += 1

    _pf_top_up()

    def one(subject):
        preloaded = None
        if prefetch is not None and subject in tickets:
            try:
                preloaded = {c: prefetch.wait(t) for c, t in tickets[subject].items()}
            except IOError:  # the runner reads the file and reports what is wrong
                preloaded = None
            finally:
                with _pf_lock:
                    _pf_outstanding[0] -= 1
            _pf_top_up()
        res = run_subject(
            cfg, pcfg, registrar, path_data, path_processed, subject,
            segmenter=segmenter, qc=qc, registrar2=registrar2, preloaded=preloaded,
        )
        write_subject_log(path_log, res)
        print(
            f"[{subject}] {'OK' if res.ok else 'FAIL'} in {res.seconds:.1f}s "
            + (f"dice={res.metrics.get('dice_after', float('nan')):.3f}" if res.ok else
               f"error={str(res.error)[:200]}"),
            flush=True,
        )
        return res

    try:
        if jobs > 1:
            with ThreadPoolExecutor(max_workers=jobs) as ex:
                results = list(ex.map(one, subjects))
        else:
            results = [one(s) for s in subjects]
    finally:
        if prefetch is not None:
            prefetch.close()
    qc.write()
    summary = write_summary(path_output, results, time.time() - t_start)
    return results, summary


def main(argv=None):
    p = argparse.ArgumentParser(
        description="BIDS batch registration+evaluation pipeline (sct_run_batch parity)."
    )
    p.add_argument("--path-data", required=True)
    p.add_argument("--path-output", required=True)
    p.add_argument("--model-path", required=True)
    p.add_argument("--model2-path", default=None, help="second model → two-step cascade")
    p.add_argument("--config-path", default=None)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--fx-contrast", default="T2w")
    p.add_argument("--mov-contrast", default="T1w")
    p.add_argument("--opt-affine", action="store_true",
                   help="enable the SC-Dice-gated centermass affine fallback")
    p.add_argument("--min-sc-dice", type=int, default=80)
    p.add_argument("--include", nargs="*", default=None,
                   help="regex/substring patterns; keep matching subjects")
    p.add_argument("--exclude", nargs="*", default=None,
                   help="regex/substring patterns; drop matching subjects")
    p.add_argument("--include-list", nargs="*", default=None,
                   help="exact subject names to keep (sct_run_batch -include-list)")
    p.add_argument("--exclude-list", nargs="*", default=None,
                   help="exact subject names to drop (sct_run_batch -exclude-list)")
    p.add_argument("--space", type=int, default=None,
                   help="shard each volume's X-axis over N chips (multi-chip)")
    p.add_argument("--data-shard", type=int, default=None,
                   help="shard the inference batch axis over N chips")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; pass cpu to run on the CPU); with "
                        "--space/--data-shard a comma-separated list names the chips")
    a = p.parse_args(argv)
    _, summary = run_batch(
        a.path_data, a.path_output, a.model_path,
        config_path=a.config_path, model2_path=a.model2_path, jobs=a.jobs,
        include=a.include, exclude=a.exclude,
        include_list=a.include_list, exclude_list=a.exclude_list,
        fx_contrast=a.fx_contrast, mov_contrast=a.mov_contrast,
        opt_affine=a.opt_affine, min_sc_dice=a.min_sc_dice,
        sharding={"space": a.space, "data": a.data_shard}, device=a.device,
    )
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
