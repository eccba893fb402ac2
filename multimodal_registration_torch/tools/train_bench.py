"""SynthMorph training-step throughput at the reference workload.

    python -m multimodal_registration_torch.tools.train_bench [--iters 6] [--batch 1]
        [--width 0] [--blocks 1] [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/train_bench.py``: ``TrainConfig`` at
160x160x192, 26 labels, ``zero_borders_maps`` on (the whole augmentation
path), enc/dec 64 or, with ``--width``, ``[width] * 4`` / ``[width] * 6``
(256 = the published inference widths). A bank of 4 label maps drawn from
``np.random.default_rng(0)`` lives on the device; each step is
:meth:`Trainer.train_step_banked` (synthesis of two images a sample, forward,
Dice + Grad loss, backward, Adam), all steps on one ``torch.Generator``.
One warm-up step, then ``--blocks`` blocks of ``--iters`` steps, each block
timed with CUDA events (the host clock on the CPU); the best block is
reported.

Prints one line to stdout, ``{"metric":
"synthmorph_train_steps_per_sec_160x160x192_b{batch}[_w{width}]", "value",
"unit": "steps/s", "sec_per_step", "final_loss"}``, the loss of the last step.
Block times, peak memory and the kernel launches of each step go to stderr
as ``#`` lines. On the card every step must launch the training kernels
(:meth:`Trainer.step_launches`); a step that launched anything else fails the run.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.tools.timing import (
    card_note, elapsed_s, note, peak_mib, reset_peak, write_result)
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer

SHAPE, NUM_LABELS, NUM_MAPS = (160, 160, 192), 26, 4


def metric_name(batch: int, width: int, shape=SHAPE) -> str:
    return "synthmorph_train_steps_per_sec_%s_b%d%s" % (
        "x".join(map(str, shape)), batch, f"_w{width}" if width else "")


def train_config(batch: int = 1, width: int = 0, shape=SHAPE,
                 num_labels: int = NUM_LABELS) -> TrainConfig:
    d = dict(in_shape=list(shape), num_labels=num_labels, batch_size=batch,
             zero_borders_maps=True, epochs=1)
    if width:
        d["enc"] = [width] * 4
        d["dec"] = [width] * 6
    return TrainConfig.from_dict(d)


def setup(cfg: TrainConfig, device):
    """The trainer, the bank of ``NUM_MAPS`` maps, the source and target
    indices of the batch (from ``default_rng(0)``) and the generator."""
    trainer = Trainer(cfg, device=device)
    rng = np.random.default_rng(0)
    bank = trainer.put_bank(rng.integers(0, cfg.num_labels, size=(NUM_MAPS, *cfg.in_shape),
                                         dtype=np.uint8))
    si, ti = trainer.put_indices(rng.integers(0, NUM_MAPS, size=cfg.batch_size),
                                 rng.integers(0, NUM_MAPS, size=cfg.batch_size))
    return trainer, bank, si, ti, trainer.generator(0)


def run(iters: int = 6, batch: int = 1, width: int = 0, blocks: int = 1, device=None,
        shape=None, num_labels: int | None = None) -> dict:
    """Time the step (at ``SHAPE`` and ``NUM_LABELS`` unless given); returns
    the stdout record plus ``blocks_s``, ``peak_mib`` and ``launches_per_step``."""
    dev = resolve_device(device)
    shape = tuple(shape or SHAPE)
    cfg = train_config(batch, width, shape, num_labels or NUM_LABELS)
    trainer, bank, si, ti, gen = setup(cfg, dev)
    want = trainer.step_launches()
    aux = {}

    def step():
        aux.update(trainer.train_step_banked(gen, bank, si, ti))

    kernels.reset_launch_counts()
    step()  # warm-up: cuDNN's choices, the kernels' libraries
    loss = float(aux["loss"])
    first = kernels.launch_counts()
    note(f"# warm-up step: loss {loss:.6f}")
    if dev.type == "cuda" and first != want:
        raise RuntimeError(f"a training step launched {first}, want {want}")
    reset_peak(dev)

    def block():
        for _ in range(iters):
            step()

    times = []
    for b in range(blocks):
        kernels.reset_launch_counts()
        times.append(elapsed_s(dev, block) / iters)
        loss = float(aux["loss"])
        got = kernels.launch_counts()
        note(f"# block {b}: {times[-1]:.6f} s/step, loss {loss:.6f}")
        if dev.type == "cuda" and got != {k: v * iters for k, v in want.items()}:
            raise RuntimeError(f"block {b}'s {iters} steps launched {got}, want {iters} x {want}")
    peak = peak_mib(dev)
    note(f"# launches per step: {json.dumps(first)}")
    note(f"# best {min(times):.6f} s/step, peak memory "
         f"{'n/a (CPU)' if peak is None else f'{peak:.1f} MiB'}")
    dt = min(times)
    return {"metric": metric_name(batch, width, shape), "value": 1.0 / dt,
            "unit": "steps/s", "sec_per_step": dt, "final_loss": loss,
            "blocks_s": times, "peak_mib": peak, "launches_per_step": first}


KEYS = ("metric", "value", "unit", "sec_per_step", "final_loss")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--width", type=int, default=0,
                    help="override enc/dec widths (256 = published inference arch)")
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    rec = run(iters=a.iters, batch=a.batch, width=a.width, blocks=a.blocks, device=dev)
    print(json.dumps({k: rec[k] for k in KEYS}), flush=True)
    write_result(a.out, rec)
    return rec


if __name__ == "__main__":
    main()
