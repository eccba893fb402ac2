"""Readings that set a cell's limits: the program's check numbers on many
seeds, and the control's, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 --seconds 3 [--arms program control]

For each seed and arm, a driver is set up as a run of the cell would set it
up, drives a short window at the cell's own load, and is checked against the
reference as a run is. The control arm is the nearest lower precision the
cell's driver module knows (its ``control_config``: the program's own int8
path for the pair cells, the reference in fp8 for training); an arm
``fault:<name>`` runs the program with the module's ``FAULTS[name]``
planted. One JSON line a reading on standard output. The benchmark's runs
never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def reading(root, workload: str, seed: int, seconds: float, arm: str, device=None,
            overrides=None) -> dict:
    import torch

    from perfbench import harness

    _, cell, config, traffic, _ = harness.load_cell(root, workload, overrides)
    mod = harness.driver_of(traffic)
    if arm == "control":
        config = mod.control_config(config)
    fault = mod.FAULTS[arm.split(":", 1)[1]] if arm.startswith("fault:") else None
    dev = device or torch.device("cuda", 0)
    drv = mod.Driver(harness.Context(cell["name"], config, traffic, seed, dev))
    t0 = time.perf_counter()
    with fault() if fault else contextlib.nullcontext():
        drv.setup()
        res = drv.window(seconds)
    drv.release()
    numbers = drv.check()
    out = {"workload": workload, "arm": arm, "seed": seed, "units": res["units"],
           "seconds": time.perf_counter() - t0, "numbers": numbers}
    del drv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--arms", nargs="+", default=["program", "control"])
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for arm in args.arms:
            print(json.dumps(reading(ROOT, args.workload, seed, args.seconds, arm)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
