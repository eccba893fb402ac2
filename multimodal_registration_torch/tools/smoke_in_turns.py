"""Run ``chip_smoke.py`` of two checkouts in turns on one card, so that their
end-to-end numbers can be compared under the same conditions of card and host:

    python -m multimodal_registration_torch.tools.smoke_in_turns --parent DIR [--out DIR]

``DIR`` holds the other checkout (for example ``git archive <commit> | tar -x
-C DIR``). The order is parent, change, change, parent; each run is its
checkout's own ``chip_smoke.py``, started from that checkout's root, and
builds its own kernels. Every run's full output goes to ``<out>/<run>.txt``;
printed are its lines that carry the end-to-end numbers (forward, training
step, profiles, the integration, K8's shapes, the published widths' forwards),
its ``kernels`` line and the card's name and power limit. Exits non-zero if a run failed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KEEP = ("#   forward:", "#   training step:", "#   profile (", "#   integration (",
        "#   the 5 squaring steps", "#   K8 ", "#   7b ", "#   7c ", "# forward_ms", '{"kernels"',
        "NVIDIA", "FAIL")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the checkout to compare with")
    ap.add_argument("--out", default=str(ROOT / "build" / "smoke_in_turns"))
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    failed = []
    for run in ("parent_a", "change_a", "change_b", "parent_b"):
        tree = trees[run.split("_")[0]]
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        (out / f"{run}.txt").write_text(proc.stdout + f"rc {proc.returncode}\n")
        print(f"== {run}: rc {proc.returncode}", flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith(KEEP):
                print(line)
        if proc.returncode != 0:
            failed.append(run)
            print("\n".join(proc.stdout.splitlines()[-15:]))
    if failed:
        raise SystemExit(f"failed: {failed}")


if __name__ == "__main__":
    main()
