"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, traffic mix, limit file and metric reader found by name."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from perfbench import flops, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])
    widths = ("enc", "dec")
    assert not set(cfg["reduced"]) & set(widths)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_pieces_found_by_name(cell):
    _, found, config, traffic, limits = harness.load_cell(ROOT, cell["name"])
    assert found is cell or found == cell
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    mod = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    for attr in ("Driver", "control_config"):
        assert hasattr(mod, attr)
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in harness.end_to_end_of(BENCH, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_of(BENCH, cell["name"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(metric):
    assert callable(harness.reader(ROOT, metric["name"]))
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for cell in metric["workloads"]:
        e2e = [m["name"] for m in harness.end_to_end_of(BENCH, cell)]
        assert metric["moves"] in e2e
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert UNIT.match(metric["unit"])


@pytest.mark.parametrize("width", [64, 256])
def test_forward_flops_and_integration_bytes_match_the_port_roofline(width):
    from multimodal_registration_torch.tools import roofline

    shape = (160, 160, 192)
    comps = roofline.components(shape, width)
    total = sum(c["flops"] for k, c in comps.items() if k != "rescale")
    assert flops.forward_flops(shape, [width] * 4, [width] * 6) == pytest.approx(total,
                                                                                  rel=1e-12)
    assert flops.integrate_bytes(shape) == comps["integrate_5steps"]["bytes"]
    if width == 64:
        assert round(total / 1e9, 1) == 777.8


def _imports(path: Path):
    import ast

    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_read_no_jax_era_folder(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "multimodal_registration_tpu", "benchmarks"}
    if "reference" in path.parts:
        assert "multimodal_registration_torch" not in tops
    assert "benchmarks" + "/" not in path.read_text()
