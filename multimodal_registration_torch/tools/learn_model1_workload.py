"""Learning of the two-step pipeline's step-1 (smooth) model, logged as a trajectory.

    python -m multimodal_registration_torch.tools.learn_model1_workload [steps] [warm]
        [--device cpu] [--out-dir DIR]

The port's counterpart of ``benchmarks/learn_model1_workload.py``: the
workload of ``tools/learn_ref_workload.py`` (160x160x192, 26 labels) with
``vel_res`` [32, 64], the smooth deformation statistics of the reference's
first model, 12000 steps by default. The held-out pairs come from generators
seeded 7000 + s, with the engine at ``svf_int_res`` 2. They are evaluated in
two regimes at step 0 and every 1000 steps or at the last one:

* ``smooth``: the pairs as synthesised (in-distribution for this model);
* ``affine``: the same pairs with the moving half displaced by a large rigid
  transform (``tools/pipeline_quality.py::rigid_displace``, seed 100 + s:
  translation up to 12 voxels, rotation up to 6 degrees about one axis).

The record (``learn_model1_results.json``) has the JAX script's keys:
``workload``, ``warm_start``, ``identity`` and ``trajectory``, the identity
and each point's metrics in ``smooth`` and ``affine`` sub-records. Without
``warm`` the default is the tool's own checkpoint
(``learned_model1_160x160x192_26lab.npz`` in ``--out-dir``), else
``benchmarks/learned_ref_160x160x192_26lab.npz``, read only. Resume, the
seeding of the training draws, the crash-safe order of the two writes and
the differences to the JAX script (``--out-dir``, warm start of a committed
checkpoint on a fresh log, the pairs from the port's generators) are those of
``tools/learn_ref_workload.py``. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.tools import learn_ref_workload as lrw
from multimodal_registration_torch.tools.pipeline_quality import rigid_displace
from multimodal_registration_torch.tools.timing import BENCHMARKS, card_note, note

SPEC = lrw.Spec("learn_model1_results.json", "learned_model1_160x160x192_26lab.npz", 7000,
                suffix=", vel_res [32, 64]",
                config=(("vel_res", [32, 64]),), regimes=("smooth", "affine"))
WARM_REF = os.path.join(BENCHMARKS, "learned_ref_160x160x192_26lab.npz")


def regimes(pairs) -> dict:
    """``smooth``: the pairs; ``affine``: their moving halves rigidly displaced."""
    affine = []
    for s, (mov, mov_lab, fx, fx_lab) in enumerate(pairs):
        amov, amov_lab = rigid_displace(mov.cpu().numpy(), mov_lab.cpu().numpy(), 100 + s)
        affine.append((torch.as_tensor(amov, device=mov.device),
                       torch.as_tensor(amov_lab, device=mov.device), fx, fx_lab))
    return {"smooth": pairs, "affine": affine}


def default_warm(out_dir: str | None) -> str:
    """The tool's own checkpoint if there is one, else the flagship's."""
    _, ckpt, _ = lrw.paths(SPEC, out_dir)
    return ckpt if os.path.exists(ckpt) else WARM_REF


def run(steps: int = 12000, warm: str | None = None, out_dir: str | None = None, device=None,
        config: dict | None = None, emit=print) -> dict:
    """One leg of the workload (``warm`` as given: :func:`main` resolves the
    default)."""
    return lrw.run_workload(SPEC, steps, warm, out_dir, device, config, regimes, emit)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=12000)
    ap.add_argument("warm", nargs="?", default=None,
                    help="warm-start checkpoint (default: resume our own run if present, "
                         "else the flagship's checkpoint)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=None,
                    help=f"the record's and the checkpoint's directory (default {lrw.OUT_DIR})")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    warm = a.warm if a.warm is not None else default_warm(a.out_dir)
    return run(a.steps, warm, a.out_dir, dev, emit=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
