"""Learning at the reference workload, logged as a trajectory with a checkpoint.

    python -m multimodal_registration_torch.tools.learn_ref_workload [steps] [warm]
        [--width W] [--device cpu] [--out-dir DIR]

The port's counterpart of ``benchmarks/learn_ref_workload.py``: 160x160x192
volumes, 26 labels, ``TrainConfig`` with ``num_maps`` 40, batch 1, lr 1e-4,
global-norm clip 1.0, ``same_subj`` (``--width 256``: enc/dec [256], the
published inference widths). ``warm`` loads a checkpoint's weights with a
fresh Adam. :meth:`Trainer.train_step_banked` trains on the bank of label maps
(seed 0), and three held-out pairs (two syntheses of a map each, the engine
at ``svf_int_res`` 2, one generator per pair seeded 5000 + s) are evaluated at
step 0 and every 1000 steps or at the last one: NMI of the fixed image and
``moved``, Dice of the moving labels warped (nearest) by ``flow_fullres``
against the fixed labels (``tools/learn_check.py::mean_label_dice``) and the
mean |flow| in voxels. The identity is measured on a fresh log; step 0's loss
is ``null``.

Resume: only when ``warm`` is the tool's own checkpoint in ``--out-dir`` and
it loaded, and its record is there. ``step_base`` is then the record's last
step, and the training draws are seeded from it (``default_rng(step_base)``
for the map indices, a generator seeded ``1 + step_base`` for the synthesis),
so each leg draws fresh pairs. Crash-safe order: at each snapshot the
checkpoint is written (a temporary file, then ``os.replace``) before the
record, so a failure between the two leaves the record one snapshot behind
the checkpoint and a resume retrains that leg. A checkpoint that does not
load raises: a trajectory is never continued from fresh weights. A resume
takes no step-0 snapshot (the JAX script takes one again when the record
stops at step 0, and records the loaded checkpoint's weights as step 0).

The record (``learn_ref_results.json``; ``learn_w<W>_results.json`` with
``--width``) has the JAX script's keys: ``workload``, ``warm_start``,
``identity`` and ``trajectory`` (``step``, ``loss``, ``nmi``, ``dice``,
``mean_abs_flow_vox``, ``sec_per_step``). Differences on purpose:

* the record and the checkpoint (``learned_ref_160x160x192_26lab.npz``,
  ``learned_w<W>_…npz``) go to ``--out-dir`` (default ``build/learn_workloads``
  in the checkout, git-ignored), never under ``benchmarks/``;
* without ``warm`` the default is the tool's own checkpoint in ``--out-dir``
  if there is one, else (width 0) ``benchmarks/learned_96cube_16lab_24k.npz``,
  read only, else from scratch. The JAX script resumed the committed
  ``benchmarks/learned_ref_…npz`` with its committed record; here a committed
  checkpoint may be passed as ``warm``, and is then a warm start on a fresh
  log, never a resume of the committed trajectory. A ``warm`` that does not
  exist raises;
* the JAX eval pairs' ``MMREG_BLUR_MODE=convolve`` pin selects a TPU lowering
  (ROADMAP item 17): the port has one blur;
* the pairs come from the port's generators, not JAX's PRNG, so absolute Dice
  and NMI are held against the identity, not against the committed JAX
  trajectory.

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.weights import params_to_jax
from multimodal_registration_torch.synth.image_engine import labels_to_image
from multimodal_registration_torch.synth.labelmaps import generate_label_maps
from multimodal_registration_torch.tools import learn_check
from multimodal_registration_torch.tools.timing import (
    BENCHMARKS, ROOT, card_note, note, outside_benchmarks)
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer

SHAPE = (160, 160, 192)
NUM_LABELS = 26
NUM_PAIRS = 3
EVAL_EVERY = 1000
EVAL_SVF_INT_RES = 2
OUT_DIR = os.path.join(ROOT, "build", "learn_workloads")
WARM_24K = os.path.join(BENCHMARKS, "learned_96cube_16lab_24k.npz")


@dataclasses.dataclass(frozen=True)
class Spec:
    """What distinguishes one trajectory workload from another."""
    results: str          # the record's file name in --out-dir
    ckpt: str             # the checkpoint's file name in --out-dir
    pair_seed: int        # the held-out pairs' generators: pair_seed + s
    suffix: str = ""      # appended to the record's workload string
    config: tuple = ()    # (key, value) entries of the TrainConfig dict
    regimes: tuple = ()   # () for one regime, else the sub-record names


def ref_spec(width: int = 0) -> Spec:
    """``--width`` 256 trains the published inference widths
    (``config_inference.json``) with files of their own."""
    if width:
        return Spec(f"learn_w{width}_results.json", f"learned_w{width}_160x160x192_26lab.npz",
                    5000,
                    config=(("enc", [width] * 4), ("dec", [width] * 6)))
    return Spec("learn_ref_results.json", "learned_ref_160x160x192_26lab.npz", 5000)


def paths(spec: Spec, out_dir: str | None):
    """``(results, ckpt, tmp)`` paths in ``out_dir`` (never under ``benchmarks/``):
    the record, the checkpoint and the checkpoint's temporary file."""
    out_dir = outside_benchmarks(out_dir or OUT_DIR, "--out-dir")
    return tuple(os.path.join(out_dir, n) for n in (spec.results, spec.ckpt, "_" + spec.ckpt))


def default_warm(spec: Spec, out_dir: str | None, width: int = 0) -> str | None:
    """The tool's own checkpoint if there is one, else (width 0) the 24k
    checkpoint of the 96^3 run, read only, else None (from scratch)."""
    _, ckpt, _ = paths(spec, out_dir)
    if os.path.exists(ckpt):
        return ckpt
    return None if width else WARM_24K


def workload_config(spec: Spec, config: dict | None = None) -> TrainConfig:
    d = dict(in_shape=list(SHAPE), num_labels=NUM_LABELS, num_maps=40, batch_size=1, lr=1e-4,
             grad_clip_norm=1.0, epochs=1, same_subj=True)
    d.update(dict(spec.config))
    d.update(config or {})
    return TrainConfig.from_dict(d)


@torch.no_grad()
def held_out_pairs(maps, engine_cfg, seed_base: int, device) -> list:
    """``(moving image, moving labels, fixed image, fixed labels)`` per pair:
    two syntheses of map ``s``, from a generator seeded ``seed_base + s``."""
    eval_cfg = dataclasses.replace(engine_cfg, svf_int_res=EVAL_SVF_INT_RES)
    pairs = []
    for s in range(NUM_PAIRS):
        gen = torch.Generator(device=device).manual_seed(seed_base + s)
        lab = torch.as_tensor(maps[s % len(maps)], device=device)
        img1, oh1 = labels_to_image(lab, eval_cfg, gen=gen)
        img2, oh2 = labels_to_image(lab, eval_cfg, gen=gen)
        pairs.append((img1, oh1.argmax(-1), img2, oh2.argmax(-1)))
    return pairs


def evaluate(model, pairs, num_labels: int) -> tuple:
    """``(nmi, dice, mean |flow|)`` rounded as the JAX script rounds."""
    e = learn_check.evaluate(model, pairs, num_labels)
    return round(e["nmi"], 4), round(e["dice"], 4), round(e["mean_abs_flow_vox"], 3)


def identity_metrics(pairs, num_labels: int) -> dict:
    e = learn_check.identity(pairs, num_labels)
    return {"nmi": round(e["nmi"], 4), "dice": round(e["dice"], 4)}


def write_record(path: str, log: dict) -> None:
    with open(path, "w") as f:
        json.dump(log, f, indent=1)


def save_weights(trainer: Trainer, tmp: str, ckpt: str) -> None:
    """The weights as a flat ``.npz`` (the JAX package's keys), written to
    ``tmp`` and moved onto ``ckpt``."""
    np.savez(tmp, **params_to_jax(trainer.model.state_dict()))
    os.replace(tmp, ckpt)


def run_workload(spec: Spec, steps: int, warm: str | None = None, out_dir: str | None = None,
                 device=None, config: dict | None = None, regimes=None, emit=print) -> dict:
    """Train ``steps`` steps and log the trajectory; returns the record.
    ``regimes(pairs)`` gives ``{name: pairs}`` for a workload evaluated in
    several regimes (``spec.regimes``)."""
    dev = resolve_device(device)
    results, ckpt, tmp = paths(spec, out_dir)
    os.makedirs(os.path.dirname(results), exist_ok=True)
    cfg = workload_config(spec, config)
    shape, L = tuple(cfg.in_shape), cfg.num_labels
    trainer = Trainer(cfg, device=dev)
    warm_loaded = False
    if warm:
        if not os.path.exists(warm):
            raise FileNotFoundError(f"warm start {warm} does not exist")
        trainer.load_checkpoint(warm)  # fresh Adam; raises if it does not load
        warm_loaded = True
        emit(f"warm-started from {warm}")

    emit("generating label maps...")
    maps = generate_label_maps(torch.Generator(device=dev).manual_seed(0), cfg.num_maps, shape,
                               L, device=dev, im_scales=cfg.im_scales,
                               def_scales=cfg.def_scales)
    bank = trainer.put_bank(np.stack(maps).astype(np.uint8))
    pairs = held_out_pairs(maps, trainer.engine_cfg, spec.pair_seed, dev)
    sets = regimes(pairs) if spec.regimes else {None: pairs}

    step_base = 0
    resume = (warm_loaded and os.path.abspath(warm) == os.path.abspath(ckpt)
              and os.path.exists(results))
    if resume:
        with open(results) as f:
            log = json.load(f)
        log["warm_start"] = warm
        if log["trajectory"]:
            step_base = int(log["trajectory"][-1]["step"])
        emit(f"resuming trajectory at step {step_base}")
    else:
        base = {k: identity_metrics(p, L) for k, p in sets.items()}
        log = {"workload": f"{shape} / {L} labels{spec.suffix}",
               "warm_start": warm or "",
               "identity": base if spec.regimes else base[None],
               "trajectory": []}

    rng = np.random.default_rng(step_base)
    gen = trainer.generator(1 + step_base)

    def snapshot(step, loss, sps):
        evals = {k: evaluate(trainer.model, p, L) for k, p in sets.items()}
        save_weights(trainer, tmp, ckpt)  # before the record: crash-safe resume
        point = {"step": step_base + step, "loss": None if loss != loss else round(loss, 4)}
        if spec.regimes:
            for k, (nmi, dice, mf) in evals.items():
                point[k] = {"nmi": nmi, "dice": dice, "mean_abs_flow_vox": mf}
            point["sec_per_step"] = round(sps, 3)
            (nmi_s, dice_s, _), (nmi_a, dice_a, _) = (evals[k] for k in spec.regimes)
            line = (f"step {step}: loss {loss:.4f} {spec.regimes[0]} {dice_s}/{nmi_s} "
                    f"{spec.regimes[1]} {dice_a}/{nmi_a} ({sps:.2f}s/step)")
        else:
            nmi, dice, mf = evals[None]
            point.update({"nmi": nmi, "dice": dice, "mean_abs_flow_vox": mf,
                          "sec_per_step": round(sps, 3)})
            line = (f"step {step}: loss {loss:.4f} dice {dice} nmi {nmi} flow {mf} "
                    f"({sps:.2f}s/step)")
        log["trajectory"].append(point)
        write_record(results, log)
        emit(line)

    t0 = time.perf_counter()
    if not resume:
        snapshot(0, float("nan"), 0.0)
    for step in range(1, steps + 1):
        idx = rng.integers(len(maps), size=1)
        si, ti = trainer.put_indices(idx, idx)
        aux = trainer.train_step_banked(gen, bank, si, ti)
        if step % EVAL_EVERY == 0 or step == steps:
            snapshot(step, float(aux["loss"]), (time.perf_counter() - t0) / step)

    emit(json.dumps(log["trajectory"][-1]))
    return log


def run(steps: int = 6000, warm: str | None = None, width: int = 0, out_dir: str | None = None,
        device=None, config: dict | None = None, emit=print) -> dict:
    """One leg of the workload (``warm`` as given: :func:`main` resolves the
    default)."""
    return run_workload(ref_spec(width), steps, warm, out_dir, device, config, emit=emit)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=6000)
    ap.add_argument("warm", nargs="?", default=None,
                    help="warm-start checkpoint (default: resume our own run "
                         "at these widths if present)")
    ap.add_argument("--width", type=int, default=0,
                    help="override enc/dec widths (256 = the published "
                         "inference architecture)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=None,
                    help=f"the record's and the checkpoint's directory (default {OUT_DIR})")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    spec = ref_spec(a.width)
    warm = a.warm if a.warm is not None else default_warm(spec, a.out_dir, a.width)
    return run(a.steps, warm, a.width, a.out_dir, dev, emit=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
