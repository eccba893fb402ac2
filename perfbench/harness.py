"""One run of one cell: find its pieces by name, set up, measure, check, print.

Everything specific to a configuration, a traffic mix, a cell or a per-layer
metric lives in a file of its own under ``perfbench/``, found by the names in
``BENCHMARK.json``:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry): the
  model as it is run, with its source, ``assumed`` and ``reduced``;
* ``traffic/<traffic>.json``: the mix's parameters and the ``driver`` that
  reads them, ``drivers/<driver>.py``;
* ``limits/<cell>.json``: the numbers that decide ``correct``, each with its
  limit;
* ``metrics/<metric>.py``: one reader of the traced run per per-layer metric,
  ``read(trace) -> float | None``.

A new cell, mix or metric is new files and new entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_registration_tpu")


class Context:
    """What a driver is given: the configuration and traffic dicts, the seed,
    the device, and the cell's name."""

    def __init__(self, cell: str, config: dict, traffic: dict, seed: int, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = int(seed), device


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_file(bench: dict, root: Path, name: str) -> Path:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return root / cfg["file"]
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports, in the file's order."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> list:
    """The per-layer metrics the cell reports: those whose ``workloads``
    list it (every per-layer entry has the list)."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def reader(root: Path, name: str):
    """``read`` of ``perfbench/metrics/<name>.py``; a metric measured alike in
    several cells under names ``<quantity>.<cells>`` may share the reader
    ``<quantity>.py`` when it has no file of its own."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = path.with_name(name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def quantity(res: dict, name: str):
    """The driver's reading of the end-to-end metric ``name``: under that
    name, or under the quantity it names, ``<quantity>.<cells>``, a metric
    measured alike in cells whose noise asks for a bound of its own."""
    return res[name] if name in res else res[name.split(".")[0]]


def driver_of(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(torch, chips: int, peak: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def load_cell(root: Path, workload: str, overrides=None) -> tuple:
    """``(bench, cell, config, traffic, limits)`` of a cell, found by name;
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) are merged in."""
    bench = load_json(root / "BENCHMARK.json")
    cell = find_cell(bench, workload)
    config = load_json(config_file(bench, root, cell["config"]))
    traffic = load_json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{cell['name']}.json")
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    return bench, cell, config, traffic, limits


def run(args, root: Path, t0: float, device=None, overrides=None) -> dict:
    """One run; returns the result line's object. ``device`` and
    ``overrides`` (``{"config": {...}, "traffic": {...}}`` merged into the
    files' dicts) are for the tests, which run a cell small on the CPU."""
    import torch

    from perfbench import trace as tr

    bench, cell, config, traffic, limits = load_cell(root, args.workload, overrides)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                             f"this machine has {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    e2e = end_to_end_of(bench, cell["name"])
    layers = per_layer_of(bench, cell["name"]) if args.trace else []
    readers = {m["name"]: reader(root, m["name"]) for m in layers}

    drv = driver_of(traffic).Driver(Context(cell["name"], config, traffic, args.seed, device))
    on_card = device.type == "cuda"
    drv.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    breakdown = dev_extra = None
    if args.trace:
        seconds = min(args.seconds, float(traffic.get("trace_seconds", 3)))
        # the same load untraced first: its rate is what the shares of a peak
        # read, so that the profiler's own cost does not enter them
        plain = drv.window(seconds)
        rate = plain["units"] / plain["seconds"]
        spans = tr.Spans()
        drv.install_spans(spans)
        with tr.profiled() as events:
            with tr.record_function(tr.WINDOW):
                res = drv.window(seconds)
        spans.close()
        trace = tr.parse(events(), res["units"], drv.trace_info(), rate)
        print(f"# rate traced {res['units'] / res['seconds']!r} untraced {rate!r} units/s",
              file=sys.stderr)
        metrics = {}
        for m in layers:
            value = readers[m["name"]](trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = trace.breakdown()
        dev_extra = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        if trace.unmatched:
            print(f"# {trace.unmatched} device operations without a launch event",
                  file=sys.stderr)
    else:
        res = drv.window(args.seconds)
        metrics = {}
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": quantity(res, m["name"]), "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.release()
    numbers = drv.check()
    checks, correct = {}, True
    # the cell's limits name the numbers it compares; the driver may read more
    for name, limit in limits.items():
        value = numbers[name]
        correct = correct and value == value and value <= limit
        checks[name] = {"value": value, "limit": limit}
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"modules the benchmark may not load are loaded: {leaked}")
    device_json = device_info(torch, cell["chips"], peak)
    if dev_extra:
        device_json.update(dev_extra)
    out = {"correct": correct, "attempted": res["attempted"], "failed": res.get("failed", 0),
           "metrics": metrics, "device": device_json}
    if breakdown is not None:
        out["breakdown"] = breakdown
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out["checks"] = checks
    return out
