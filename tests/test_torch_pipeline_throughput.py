"""The port's pipeline-throughput tool (``tools/pipeline_throughput.py``) on the CPU.

  * its flags, defaults, configurations, the dataset's maps seed and the
    document's keys (per configuration and at the top) equal
    ``benchmarks/pipeline_throughput.py``'s, read from its syntax tree;
    ``--device`` and ``--out`` are the port's own;
  * ``--quick`` runs 2 subjects through ``run_batch`` in each of ``default``,
    ``noprefetch`` and ``jobs2``: every subject ok, the rates follow their
    formulas (float64 on the same floats: exact), the phase totals name the
    register and evaluate phases and are the subjects' timings summed;
  * ``noprefetch`` sets ``MMREG_NO_PREFETCH`` for its run only;
  * ``--dataset-dir`` builds the dataset once and reuses it; an unknown
    configuration raises, ``--out`` never writes under ``benchmarks/``.
"""

import ast
import json
import os

import pytest

from multimodal_registration_torch.tools import pipeline_quality as pq
from multimodal_registration_torch.tools import pipeline_throughput as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "benchmarks", "pipeline_throughput.py")


@pytest.fixture(scope="module")
def ref():
    tree = ast.parse(open(JAX_SCRIPT).read(), JAX_SCRIPT)
    out = {"flags": {}}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            out["flags"][n.args[0].value] = (
                ast.literal_eval(kw["default"]) if "default" in kw else False)
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "build_dataset":
            out["maps_seed"] = next(ast.literal_eval(k.value) for k in n.keywords
                                    if k.arg == "maps_seed")
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict):
            target = n.targets[0]
            keys = [k.value for k in n.value.keys]
            if getattr(target, "id", None) == "MODES":
                out["modes"] = {k: {kw.arg: ast.literal_eval(kw.value) for kw in v.keywords}
                                for k, v in zip(keys, n.value.values)}
            elif getattr(target, "id", None) == "out_doc":
                out["doc_keys"] = keys
            elif isinstance(target, ast.Subscript):
                out["config_keys"] = keys
    return out


def test_flags_modes_and_keys_equal_the_jax_scripts(ref):
    flags = {a.option_strings[0]: a.default for a in pt.build_parser()._actions
             if a.option_strings and a.option_strings[0] != "-h"}
    assert {k: v for k, v in flags.items() if k not in ("--device", "--out")} == ref["flags"]
    assert ref["flags"]["--configs"] == "default,noprefetch,jobs2"
    assert pt.MODES == ref["modes"]
    assert pt.MAPS_SEED == ref["maps_seed"] == 4242
    assert ref["doc_keys"] == ["workload", "n_subjects", "dataset_build_s", "configs"]
    assert ref["config_keys"] == ["ok", "wall_s", "subjects_per_min", "subjects_per_min_steady",
                                  "per_subject_s", "phase_totals_s"]


def test_quick_runs_every_configuration(ref, monkeypatch, tmp_path):
    seen = {}
    real = pt.run_batch

    def spy(**kw):
        seen[kw["path_output"]] = (os.environ.get("MMREG_NO_PREFETCH"), kw["jobs"])
        return real(**kw)

    monkeypatch.setattr(pt, "run_batch", spy)
    monkeypatch.delenv("MMREG_NO_PREFETCH", raising=False)
    lines = []
    doc = pt.run(("default", "noprefetch", "jobs2"), 2, quick=True, device="cpu",
                 emit=lines.append)
    assert list(doc) == ref["doc_keys"]
    assert doc["n_subjects"] == 2 and doc["dataset_build_s"] > 0
    assert doc["workload"] == f"{pq.QUICK_SHAPE} / {pq.QUICK_LABELS} labels"
    assert {os.path.basename(k): v for k, v in seen.items()} == {
        "out_default": (None, 1), "out_noprefetch": ("1", 1), "out_jobs2": (None, 2)}
    assert "MMREG_NO_PREFETCH" not in os.environ
    assert [ln.split()[0] for ln in lines[:3]] == ["default", "noprefetch", "jobs2"]
    for name, c in doc["configs"].items():
        assert list(c) == ref["config_keys"], name
        assert c["ok"] and len(c["per_subject_s"]) == 2
        assert c["subjects_per_min"] == 2 / c["wall_s"] * 60
        assert c["subjects_per_min_steady"] == 1 / c["per_subject_s"][1] * 60
        assert "register" in c["phase_totals_s"] and "evaluate" in c["phase_totals_s"]


def test_phase_totals_sum_the_subjects_timings():
    from types import SimpleNamespace

    results = [SimpleNamespace(timings={"register": 1.5, "qc": 0.25}),
               SimpleNamespace(timings={"register": 2.0}), SimpleNamespace(timings=None)]
    assert pt.phase_totals(results) == {"register": 3.5, "qc": 0.25}


def test_dataset_dir_is_reused_and_bad_arguments_raise(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    subjects, t = pt.dataset(data, 2, True, pt.resolve_device("cpu"), reuse=True)
    assert subjects == ["sub-01", "sub-02"] and t > 0
    monkeypatch.setattr(pq, "build_dataset", lambda *a, **k: pytest.fail("rebuilt"))
    assert pt.dataset(data, 2, True, pt.resolve_device("cpu"), reuse=True) == (subjects, 0.0)
    with pytest.raises(ValueError, match="unknown configurations"):
        pt.run(("default", "jobs3"), 2, quick=True, device="cpu")
    with pytest.raises(ValueError, match="never write under"):
        pt.write_result(os.path.join(ROOT, "benchmarks", "x.json"), {})
    pt.write_result(str(tmp_path / "o" / "doc.json"), {"a": 1})
    assert json.load(open(tmp_path / "o" / "doc.json")) == {"a": 1}


def test_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.main(["--quick", "--subjects", "1"])
