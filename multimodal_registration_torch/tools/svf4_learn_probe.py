"""Head-to-head learning check of the synthesis's integration grid: ``svf_int_res`` 2 against 4.

    python -m multimodal_registration_torch.tools.svf4_learn_probe [steps] [--small]
        [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/svf4_learn_probe.py``. ``svf_int_res``
is the grid on which the training-time generator integrates its deformation
(``TrainConfig``'s default 4, a quarter grid, as in the JAX package; 2 is the
half grid). The coarser grid is faster but changes the augmentation's field
distribution, which only training can judge. So two arms, ``svf_int_res`` 2
and 4, train the flagship model from scratch, and both are evaluated on the
same held-out pairs:

* the configuration is ``tools/learn_check.py::check_config`` (16 maps,
  batch 1, lr 1e-4, global-norm clip 1.0, ``same_subj``) at 96^3, 16 labels,
  Perlin scales [8, 16, 32] / [8, 16], evaluated every 1000 steps and after
  the last (``--small``: 32^3, 4 labels, [8, 16] / [8], every 200); the two
  arms' configurations differ in ``svf_int_res`` only;
* the map bank (``learn_check.map_bank``, generator seed 0) and the three
  held-out pairs (``learn_check.held_out_pairs``: the engine at
  ``svf_int_res`` 2, a generator seeded 1000) are made once, before either
  arm, and shared, so the evaluation does not depend on the arm;
* each arm builds a fresh :class:`Trainer` (its weights from
  ``TrainConfig.seed``, as the JAX arm's ``init_state()``), draws the map
  indices from ``np.random.default_rng(0)`` and trains on a generator seeded
  1; the seeds are not JAX's keys, so what matches the JAX script is the
  schedule and the sharing, not the draws.

An evaluation gives the mean NMI of the fixed image and ``moved`` and the
mean Dice of the moving labels warped (nearest) by ``flow_fullres``
(``learn_check.evaluate``), rounded to 4 places with the step's loss;
``sec_per_step`` is the wall time since the arm began (evaluations
included, the card synchronised first) over the step, rounded to 3 places,
as the JAX script takes it.

Prints the JAX script's lines: ``{"identity": ...}``, one ``{"arm", "step",
"loss", "nmi", "dice", "sec_per_step"}`` per evaluation, and the record
``{"workload", "steps", "identity", "arms": {"2": [...], "4": [...]}}``, which
``--out`` also writes (never under ``benchmarks/``). ``probe(..., over=...)``
overrides the configuration (the CPU tests' tiny size), a function argument,
not a flag. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.tools import learn_check
from multimodal_registration_torch.tools.timing import card_note, note, write_result
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer, engine_config_from

ARMS = (2, 4)
FULL = dict(shape=(96, 96, 96), num_labels=16,
            scales=dict(im_scales=[8, 16, 32], def_scales=[8, 16]), eval_every=1000)
SMALL = dict(shape=(32, 32, 32), num_labels=4,
             scales=dict(im_scales=[8, 16], def_scales=[8]), eval_every=200)


def probe_config(small: bool, svf_int_res: int, over: dict | None = None) -> TrainConfig:
    """An arm's configuration: ``learn_check``'s at the probe's size, with
    ``over`` applied and the arm's ``svf_int_res``."""
    size = SMALL if small else FULL
    cfg = learn_check.check_config(size["shape"], size["num_labels"], scales=size["scales"])
    return dataclasses.replace(cfg, **(over or {}), svf_int_res=svf_int_res)


def _seconds_since(t0: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def probe(steps: int = 3000, small: bool = False, device=None, emit=print,
          over: dict | None = None):
    """Run both arms; returns ``(record, state)``: the JSON-ready record and
    ``{"configs", "pairs", "trainers"}`` (each arm's config, the pairs both
    arms were evaluated on, each arm's trained :class:`Trainer`)."""
    if steps < 1:
        raise ValueError(f"steps must be positive, got {steps}")
    dev = resolve_device(device)
    eval_every = (SMALL if small else FULL)["eval_every"]
    configs = {r: probe_config(small, r, over) for r in ARMS}
    base = configs[2]
    shape, num_labels = tuple(base.in_shape), base.num_labels

    # the map bank and the held-out pairs, once, from the /2 engine
    maps = learn_check.map_bank(base, dev, num_maps=base.num_maps)
    pairs = learn_check.held_out_pairs(maps, engine_config_from(base),
                                       torch.Generator(device=dev).manual_seed(
                                           learn_check.SEED_PAIRS), dev)
    ident = {k: round(v, 4) for k, v in learn_check.identity(pairs, num_labels).items()}
    record = {"workload": f"{shape} / {num_labels} labels", "steps": steps,
              "identity": ident, "arms": {}}
    emit(json.dumps({"identity": ident}))

    state = {"configs": configs, "pairs": pairs, "trainers": {}}
    for r in ARMS:
        trainer = Trainer(configs[r], device=dev)
        bank = trainer.put_bank(np.stack(maps).astype(np.uint8))
        rng = np.random.default_rng(learn_check.SEED_INDICES)
        gen = trainer.generator(learn_check.SEED_TRAIN)
        traj = []
        t0 = time.perf_counter()
        for step in range(1, steps + 1):
            idx = rng.integers(len(maps), size=1)
            si, ti = trainer.put_indices(idx, idx)
            aux = trainer.train_step_banked(gen, bank, si, ti)
            if step % eval_every == 0 or step == steps:
                ev = learn_check.evaluate(trainer.model, pairs, num_labels)
                traj.append({"step": step, "loss": round(float(aux["loss"]), 4),
                             "nmi": round(ev["nmi"], 4), "dice": round(ev["dice"], 4),
                             "sec_per_step": round(_seconds_since(t0, dev) / step, 3)})
                emit(json.dumps({"arm": r, **traj[-1]}))
        record["arms"][str(r)] = traj
        state["trainers"][r] = trainer
    emit(json.dumps(record))
    return record, state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=3000)
    ap.add_argument("--small", action="store_true",
                    help="32^3, 4 labels, an evaluation every 200 steps")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    record, _ = probe(a.steps, a.small, dev)
    write_result(a.out, record)
    return record


if __name__ == "__main__":
    main()
