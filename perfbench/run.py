"""The benchmark of ``multimodal_registration_torch`` on one NVIDIA GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each number that
decided ``correct`` beside its limit, which are also the last lines of
standard error. Exits non-zero without a result when the machine lacks the
cards the cell asks for, or when JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, on the path: perfbench.trace is no stdlib trace
sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.chdir(ROOT)
    from perfbench import harness

    out = harness.run(args, ROOT, T0)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
