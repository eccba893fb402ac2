"""Whole runs of each cell at a small size on the CPU: the result line's
schema, the faults that must make ``correct`` false, the controls, the
isolation check, and the exit without a card."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CPU = torch.device("cpu")
FLAGSHIP = harness.load_json(ROOT / "perfbench" / "configs" / "flagship64.json")["model"]


def small(cell: str, width: int = 8) -> dict:
    """A cell cut to 32^3, 6 labels and ``width`` channels for the CPU."""
    model = {**FLAGSHIP, "enc": [width] * 4, "dec": [width] * 6, "num_labels": 6,
             "in_shape": [32, 32, 32], "im_scales": [4, 8, 16], "def_scales": [4, 8, 16]}
    traffic = ({"maps": 3, "sequence": 64} if cell.endswith("train_b1") else
               {"shape": [32, 32, 32], "pairs": 2, "maps": 2, "warm_calls": 1,
                "check_sample": 3, "trace_seconds": 1})
    return {"config": {"model": model}, "traffic": traffic}


def run(cell: str, trace: int = 0, seed: int = 2**31 + 5, seconds: float = 1.0) -> dict:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return harness.run(args, ROOT, time.perf_counter(), device=CPU, overrides=small(cell))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_result_line_schema(cell, trace):
    out = run(cell, trace)
    assert list(out) [:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool) and out["attempted"] > 0 and out["failed"] == 0
    limits = harness.load_json(ROOT / "perfbench" / "limits" / f"{cell}.json")
    assert set(out["checks"]) == set(limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in harness.per_layer_of(BENCH, cell)}
        assert set(out["metrics"]) <= allowed
    else:
        want = {m["name"] for m in harness.end_to_end_of(BENCH, cell)}
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_pairs_answer_altered_is_not_correct(monkeypatch):
    from multimodal_registration_torch.infer import register

    real = register.Registrar.predict_tensors

    def altered(self, mov, fx):
        moved, warp = real(self, mov, fx)
        moved = moved.clone()
        moved[0, 5, 5, 5] += 0.5
        return moved, warp

    monkeypatch.setattr(register.Registrar, "predict_tensors", altered)
    for cell in ("flagship64.device_pairs", "w256.device_pairs"):
        out = run(cell)
        assert out["correct"] is False
        assert out["checks"]["moved_max_abs"]["value"] >= 0.4


def test_pairs_integration_step_returning_its_state_is_not_correct(monkeypatch):
    from multimodal_registration_torch.models import vxm_dense

    monkeypatch.setattr(vxm_dense, "integrate_svf_batch",
                        lambda vel, steps, *a, **k: vel.float() / 2 ** steps)
    for cell in ("flagship64.device_pairs", "w256.device_pairs"):
        out = run(cell)
        moved = out["checks"]["moved_max_abs"]
        assert out["correct"] is False and moved["value"] > moved["limit"]


def test_training_step_leaving_its_state_unchanged_is_not_correct():
    from perfbench.drivers import train

    with train.FAULTS["state_unchanged"]():
        out = run("flagship64.train_b1")
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_pair_control_reads_far_above_the_program():
    over = small("flagship64.device_pairs", width=64)
    prog = control.reading(ROOT, "flagship64.device_pairs", 7, 0.5, "program", CPU, over)
    ctl = control.reading(ROOT, "flagship64.device_pairs", 7, 0.5, "control", CPU, over)
    assert ctl["numbers"]["moved_max_abs"] > 3 * prog["numbers"]["moved_max_abs"]


def test_training_control_departs_from_the_reference():
    # at 32^3 the program's bf16 synthesis payload flips labels enough to read
    # as high as the control; the separation is read on the card at full size
    ctl = control.reading(ROOT, "flagship64.train_b1", 5, 0.1, "control", CPU,
                          small("flagship64.train_b1"))
    got = ctl["numbers"]
    # the program drives the window; the followed step's readings are fp8's
    assert ctl["units"] >= 1 and got["grad_gap_median"] > 0.005
    assert got["change_gap_median"] > 0.0 and got["window_grad_gap_median"] > 0.005


def test_training_step_of_the_window_is_followed_from_its_own_state():
    from perfbench.drivers import train

    over = small("flagship64.train_b1")
    got = control.reading(ROOT, "flagship64.train_b1", 9, 0.5, "program", CPU, over)
    assert got["units"] >= 1
    assert set(got["numbers"]) >= {"window_grad_gap", "window_grad_gap_median",
                                   "window_change_gap", "window_change_gap_median"}
    # a step of the window that leaves the state unchanged, the set-up sound
    real = train.Driver.window

    def window(self, seconds):
        with train.FAULTS["state_unchanged"]():
            return real(self, seconds)

    train.Driver.window = window
    try:
        out = run("flagship64.train_b1", seconds=0.5)
    finally:
        train.Driver.window = real
    assert out["correct"] is False
    assert out["checks"]["window_change_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["change_gap"]["value"] < 0.5


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "multimodal_registration_tpu_extra", object())
    assert harness.forbidden_modules() == ["jax"]


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "flagship64.device_pairs", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "correct" not in r.stdout


def test_alone_without_the_program_exits_without_a_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "flagship64.device_pairs", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "correct" not in r.stdout
