"""On the card: each cell runs from its files, short, and comes out correct;
the pair cells' control (the program's int8 path), the training cell's
control (the reference in fp8) and its planted fault (a step that leaves the
state unchanged) each read above one of the cell's committed limits.
Marked ``cuda``; each test decides whether a card is there."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    need_card()
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                        "2147483999", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith("device_pairs")])
def test_pair_control_fails_the_limits_on_the_card(cell):
    need_card()
    limits = harness.load_json(ROOT / "perfbench" / "limits" / f"{cell}.json")
    got = control.reading(ROOT, cell, 2147483998, 1.0, "control")["numbers"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["control", "fault:state_unchanged"])
def test_training_control_and_fault_fail_the_limits_on_the_card(arm):
    need_card()
    cell = "flagship64.train_b1"
    limits = harness.load_json(ROOT / "perfbench" / "limits" / f"{cell}.json")
    got = control.reading(ROOT, cell, 2147483997, 2.0, arm)["numbers"]
    assert any(not got[k] <= limits[k] for k in limits), got
