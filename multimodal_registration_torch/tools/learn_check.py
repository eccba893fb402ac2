"""Closed-loop learning check of the port's training, on held-out pairs.

    python -m multimodal_registration_torch.tools.learn_check [steps] [--warm NPZ]
        [--shape X Y Z] [--labels L] [--device cpu]

The port's counterpart of ``benchmarks/learn_check.py``. It runs one arm, at
``TrainConfig``'s ``svf_int_res``; ``tools/svf4_learn_probe.py`` (the
counterpart of ``benchmarks/svf4_learn_probe.py``) trains two, at 2 and 4, on
this module's map bank and pairs. It trains the flagship model (``TrainConfig``'s
widths and defaults; batch 1, ``same_subj``, lr 1e-4, global-norm clip 1.0)
with :meth:`Trainer.train_step_banked` on a bank of 16 label maps made by
``synth/labelmaps``, and holds its registrations of three held-out pairs
against the identity. A pair is two synthesisations of one map of the bank
by the engine at its default ``svf_int_res`` of 2 (the JAX probes' eval
engine), drawn from a generator seeded apart from training. The pairs are
new syntheses of maps the model trains on, as in the JAX probes: no unseen
map is evaluated, so the check shows learning, not generalisation. On a pair:
Dice of the moving labels warped (nearest, kernel K2) by ``flow_fullres``
against the fixed labels, the mean over labels 1..L-1 present in either
(:func:`mean_label_dice`), and NMI of the fixed image and ``moved``
(``evalx/nmi``). The model is evaluated every 1000 steps and after the last;
with ``--warm`` it loads a checkpoint (fresh Adam) and is evaluated before
the first step too. Each step is timed by a :class:`StepTimer` that waits
for the card.

Prints one JSON line: the identity's Dice and NMI, the ``trajectory`` (step,
loss, Dice, NMI, mean |flow| in voxels, mean s/step so far), the mean loss
of the first and of the last ``loss_window`` steps, ``step_seconds``
(``StepTimer.summary()``) and ``learned``: NMI and Dice after the last step
both above the identity's. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.evalx.nmi import normalized_mutual_information
from multimodal_registration_torch.ops.warp import warp
from multimodal_registration_torch.synth.image_engine import labels_to_image
from multimodal_registration_torch.synth.labelmaps import generate_label_maps
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer
from multimodal_registration_torch.utils.profiling import StepTimer

NUM_MAPS = 16
NUM_PAIRS = 3
EVAL_EVERY = 1000
LOSS_WINDOW = 200
# the label maps' Perlin scales: from scratch those of the svf4 probe; a warm
# start keeps the config defaults that the in-repo checkpoints were trained on
# (benchmarks/learn_ref_workload.py)
SCRATCH_SCALES = dict(im_scales=[8, 16, 32], def_scales=[8, 16])
EVAL_SVF_INT_RES = 2
# seeds: the map bank, the map indices, training synthesis, the held-out pairs
SEED_MAPS, SEED_INDICES, SEED_TRAIN, SEED_PAIRS = 0, 0, 1, 1000


def mean_label_dice(a_lab: torch.Tensor, b_lab: torch.Tensor, num_labels: int) -> float:
    """Mean Dice over the labels 1..``num_labels``-1 present in either map
    (1.0 when none is), the JAX probes' formula
    (``benchmarks/svf4_learn_probe.py::_mean_label_dice``) from one confusion
    matrix counted on the maps' device. Labels must lie in ``[0, num_labels)``."""
    a, b = a_lab.reshape(-1).long(), b_lab.reshape(-1).long()
    for x in (a, b):
        if x.numel() and (int(x.min()) < 0 or int(x.max()) >= num_labels):
            raise ValueError(f"labels outside [0, {num_labels})")
    conf = torch.bincount(a * num_labels + b, minlength=num_labels ** 2)
    conf = conf.reshape(num_labels, num_labels).cpu().numpy()
    ds = []
    for lab in range(1, num_labels):
        denom = conf[lab, :].sum() + conf[:, lab].sum()
        if denom == 0:
            continue
        ds.append(2.0 * conf[lab, lab] / denom)
    return float(np.mean(ds)) if ds else 1.0


@torch.no_grad()
def held_out_pairs(maps: list, engine_cfg, gen: torch.Generator, device) -> list:
    """``NUM_PAIRS`` pairs ``(moving image, moving labels, fixed image, fixed
    labels)``, each two synthesisations of one map."""
    eval_cfg = dataclasses.replace(engine_cfg, svf_int_res=EVAL_SVF_INT_RES)
    pairs = []
    for s in range(NUM_PAIRS):
        lab = torch.as_tensor(maps[s % len(maps)], device=device)
        img1, oh1 = labels_to_image(lab, eval_cfg, gen=gen)
        img2, oh2 = labels_to_image(lab, eval_cfg, gen=gen)
        pairs.append((img1, oh1.argmax(-1), img2, oh2.argmax(-1)))
    return pairs


@torch.inference_mode()
def evaluate(model, pairs: list, num_labels: int, impl=None) -> dict:
    """Mean Dice, NMI and mean |flow_fullres| (voxels) of ``model`` over the
    pairs; ``impl="plain"`` runs the forward and the label warp through the
    kernels' plain versions."""
    model.eval()
    dices, nmis, flows = [], [], []
    for mov, mov_lab, fx, fx_lab in pairs:
        out = model(mov[None, ..., None], fx[None, ..., None], impl=impl)
        flow = out["flow_fullres"][0]
        moved_lab = warp(mov_lab.float(), flow, interp="nearest", impl=impl)
        dices.append(mean_label_dice(fx_lab, moved_lab, num_labels))
        nmis.append(normalized_mutual_information(fx.cpu().numpy(),
                                                  out["moved"][0, ..., 0].cpu().numpy(),
                                                  device=fx.device))
        flows.append(float(flow.abs().mean()))
    return {"dice": float(np.mean(dices)), "nmi": float(np.mean(nmis)),
            "mean_abs_flow_vox": float(np.mean(flows))}


def identity(pairs: list, num_labels: int) -> dict:
    return {"dice": float(np.mean([mean_label_dice(fx_lab, mov_lab, num_labels)
                                   for _, mov_lab, _, fx_lab in pairs])),
            "nmi": float(np.mean([normalized_mutual_information(
                fx.cpu().numpy(), mov.cpu().numpy(), device=fx.device)
                for mov, _, fx, _ in pairs]))}


def check_config(shape=(96, 96, 96), num_labels: int = 16, warm: bool = False,
                 scales: dict | None = None) -> TrainConfig:
    """The check's training configuration at ``shape`` and ``num_labels``;
    from scratch the label maps' Perlin ``scales`` (``im_scales``,
    ``def_scales``; default :data:`SCRATCH_SCALES`)."""
    return TrainConfig.from_dict(dict(
        in_shape=list(shape), num_labels=num_labels, num_maps=NUM_MAPS, batch_size=1,
        lr=1e-4, grad_clip_norm=1.0, epochs=1, same_subj=True,
        **({} if warm else scales or SCRATCH_SCALES)))


def map_bank(cfg: TrainConfig, device, num_maps: int = NUM_MAPS) -> list:
    """The check's label maps (numpy uint8), the first ``num_maps`` of its bank."""
    return generate_label_maps(torch.Generator(device=device).manual_seed(SEED_MAPS), num_maps,
                               tuple(cfg.in_shape), cfg.num_labels, device=device,
                               im_scales=cfg.im_scales, def_scales=cfg.def_scales)


def learn_check(steps: int = 3000, shape=(96, 96, 96), num_labels: int = 16,
                warm: str | None = None, device=None):
    """Run the check; returns ``(result, trainer, bank)``: the JSON-ready
    result, and the trained :class:`Trainer` with its map bank on the device."""
    if steps < 0 or (steps == 0 and not warm):
        raise ValueError(f"steps must be positive (or 0 with a warm start), got {steps}")
    dev = resolve_device(device)
    cfg = check_config(shape, num_labels, bool(warm))
    trainer = Trainer(cfg, device=dev)
    if warm:
        trainer.load_checkpoint(warm)
    maps = map_bank(cfg, dev)
    bank = trainer.put_bank(np.stack(maps).astype(np.uint8))
    pairs = held_out_pairs(maps, trainer.engine_cfg, trainer.generator(SEED_PAIRS), dev)
    base = identity(pairs, num_labels)

    timer = StepTimer(sync=dev if dev.type == "cuda" else None)
    trajectory = []

    def snapshot(step, loss):
        done = timer.records
        trajectory.append({"step": step, "loss": loss, **evaluate(trainer.model, pairs, num_labels),
                           "sec_per_step": (sum(r["seconds"] for r in done) / len(done)
                                            if done else 0.0)})

    if warm:
        snapshot(0, None)
    rng = np.random.default_rng(SEED_INDICES)
    gen = trainer.generator(SEED_TRAIN)
    losses = []
    for step in range(1, steps + 1):
        timer.start()
        idx = rng.integers(len(maps), size=1)
        si, ti = trainer.put_indices(idx, idx)
        aux = trainer.train_step_banked(gen, bank, si, ti)
        timer.stop(step=step)
        losses.append(aux["loss"])
        if step % EVAL_EVERY == 0 or step == steps:
            snapshot(step, float(aux["loss"]))

    losses = torch.stack(losses).float().cpu().numpy() if losses else np.zeros(0)
    window = max(1, min(LOSS_WINDOW, steps // 2))
    last = trajectory[-1]
    result = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "shape": list(shape), "num_labels": num_labels, "steps": steps, "warm": warm,
        "identity": base, "trajectory": trajectory,
        "loss_window": window,
        "loss_first_mean": float(losses[:window].mean()) if steps else None,
        "loss_last_mean": float(losses[-window:].mean()) if steps else None,
        "step_seconds": timer.summary(),
        "nmi_identity": base["nmi"], "nmi_after": last["nmi"],
        "dice_identity": base["dice"], "dice_after": last["dice"],
        "learned": bool(last["nmi"] > base["nmi"] and last["dice"] > base["dice"]),
    }
    return result, trainer, bank


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Closed-loop learning check of the port's "
                                            "training on held-out synthetic pairs.")
    p.add_argument("steps", nargs="?", type=int, default=3000)
    p.add_argument("--warm", default=None, help="start from this .npz checkpoint")
    p.add_argument("--shape", nargs=3, type=int, default=[96, 96, 96])
    p.add_argument("--labels", type=int, default=16)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    result, _, _ = learn_check(a.steps, tuple(a.shape), a.labels, a.warm, a.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
