"""Training CLI, the port's counterpart of ``train_synthmorph.py``:

    python -m multimodal_registration_torch.train.cli --config-path config/config.json

Flow: load the config, generate (on the device) or load the label maps,
seeded shuffle and train/val split, build the trainer, save the epoch-0
checkpoint, fit with per-epoch ``metrics.csv`` rows and checkpoints, save
``final``. Runs on the GPU unless ``--device cpu`` is given. With
``num_devices`` > 1 in the config the batch is split over that many devices
(data-parallel, ``train/trainer.py``): every card by default, or those
``--device`` lists (``cuda:0,cuda:1``; one may repeat; ``cpu`` repeats the
CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time

import numpy as np
import torch

from multimodal_registration_torch.ops.pool import TIES
from multimodal_registration_torch.parallel.mesh import first_device
from multimodal_registration_torch.synth.labelmaps import generate_label_maps
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer
from multimodal_registration_torch.utils import io as vio
from multimodal_registration_torch.utils import nifti


def _tensorboard_writer(log_dir):
    """A context that yields a ``SummaryWriter`` on ``log_dir`` when
    ``MMREG_TENSORBOARD=1`` and a log directory is set, else ``None``.
    Without the ``tensorboard`` package the scalars are left out with one
    warning line; the run goes on."""
    if not log_dir or os.environ.get("MMREG_TENSORBOARD") != "1":
        return contextlib.nullcontext()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"warning: MMREG_TENSORBOARD=1 but TensorBoard is unavailable ({e}); "
              "no scalars are written", flush=True)
        return contextlib.nullcontext()
    return SummaryWriter(log_dir)


def run_training(cfg: TrainConfig, max_steps: int | None = None, device=None,
                 pool_tie: str = "equal") -> dict:
    """The whole training flow; returns summary metrics: ``history`` (one row
    per epoch), ``params`` (the final state dict), ``steps``, ``step_seconds``
    (host seconds of each step, each ending in a read of the loss) and the
    ``trainer``."""
    dev = first_device(device)
    if cfg.num_devices is not None and cfg.batch_size % cfg.num_devices:
        raise ValueError(f"batch size {cfg.batch_size} not a multiple of the number of "
                         f"devices {cfg.num_devices}")

    # ---- label maps ---------------------------------------------------------
    if cfg.gen_label:
        label_maps = generate_label_maps(
            torch.Generator(device=dev).manual_seed(cfg.seed),
            cfg.num_maps, cfg.in_shape, cfg.num_labels, device=dev,
            im_scales=cfg.im_scales, def_scales=cfg.def_scales,
            im_max_std=cfg.im_max_std, def_max_std=cfg.def_max_std,
        )
        if cfg.save_label:
            os.makedirs(cfg.label_dir, exist_ok=True)
            # 3-D maps -> .nii.gz, 2-D maps -> .png
            if len(cfg.in_shape) == 3:
                for i, m in enumerate(label_maps):
                    nifti.save(
                        nifti.NiftiImage(m, np.eye(4)),
                        os.path.join(cfg.label_dir, f"label_map_{cfg.add_str}{i + 1}.nii.gz"))
            else:
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                for i, m in enumerate(label_maps):
                    plt.imsave(
                        os.path.join(cfg.label_dir, f"label_map_{cfg.add_str}{i + 1}.png"), m)
    else:
        labels_in, label_maps = vio.load_labels(cfg.label_dir)
        # the synthesis engine one-hots by POSITION (values must lie in
        # [0, num_labels)): remap raw label values (e.g. FreeSurfer ids 0, 2,
        # 41, ...) to contiguous indices and size the engine to their count
        labels_in = np.asarray(labels_in)
        if labels_in.min() != 0 or labels_in.max() != len(labels_in) - 1:
            lut = np.zeros(int(labels_in.max()) + 1, np.int32)
            lut[labels_in.astype(np.int64)] = np.arange(len(labels_in), dtype=np.int32)
            label_maps = [lut[np.asarray(m, np.int64)] for m in label_maps]
        if len(labels_in) != cfg.num_labels:
            print(f"loaded maps have {len(labels_in)} distinct labels; "
                  f"overriding num_labels={cfg.num_labels}")
            cfg.num_labels = int(len(labels_in))

    # seeded shuffle + split
    np.random.seed(42)
    label_maps = list(label_maps)
    np.random.shuffle(label_maps)
    n_tr = int(len(label_maps) * cfg.train_frac)
    maps_tr, maps_val = label_maps[:n_tr], label_maps[n_tr:]

    if cfg.gen_label_only:
        return {"label_maps": len(label_maps)}

    # ---- dirs ---------------------------------------------------------------
    model_dir = cfg.model_dir
    log_dir = cfg.log_dir
    if cfg.bool_sub_dir:
        model_dir = os.path.join(model_dir, cfg.sub_dir)
        if log_dir:
            log_dir = os.path.join(log_dir, cfg.sub_dir)
    os.makedirs(model_dir, exist_ok=True)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    # ---- trainer ------------------------------------------------------------
    trainer = Trainer(cfg, device=device, pool_tie=pool_tie)
    init_epoch = cfg.init_epoch
    if cfg.bool_init_weights:
        trainer.load_checkpoint(cfg.init_weights, with_opt=True)

    # the epoch-0 snapshot is always saved before the fit
    trainer.save_checkpoint(os.path.join(model_dir, f"{init_epoch:04d}"), init_epoch)

    bank_tr = trainer.put_bank(np.stack(maps_tr).astype(np.uint8))
    bank_val = trainer.put_bank(np.stack(maps_val).astype(np.uint8)) if maps_val else None

    steps_per_epoch = max(len(maps_tr) // cfg.batch_size, 1)
    val_steps = (len(maps_val) // cfg.batch_size_val) if maps_val else 0
    rng = np.random.default_rng(cfg.seed)
    gen = trainer.generator(cfg.seed + 1)

    metrics_path = os.path.join(log_dir or model_dir, "metrics.csv")
    new_file = not os.path.exists(metrics_path)
    history, step_seconds = [], []
    total_steps = 0
    with open(metrics_path, "a", newline="") as metrics_f, \
            _tensorboard_writer(log_dir) as tb_writer:
        writer = csv.writer(metrics_f)
        if new_file:
            writer.writerow(["epoch", "loss", "dice_loss", "grad_loss", "val_loss",
                             "sec_per_step"])
        for epoch in range(init_epoch, cfg.epochs):
            t0 = time.time()
            ep_losses = []
            for _ in range(steps_per_epoch):
                t_step = time.perf_counter()
                idx = rng.integers(len(maps_tr), size=2 * cfg.batch_size)
                src_idx = idx[: cfg.batch_size]
                trg_idx = src_idx if cfg.same_subj else idx[cfg.batch_size:]
                si, ti = trainer.put_indices(src_idx, trg_idx)
                aux = trainer.train_step_banked(gen, bank_tr, si, ti)
                ep_losses.append(float(aux["loss"]))  # waits for the device
                step_seconds.append(time.perf_counter() - t_step)
                total_steps += 1
                if max_steps is not None and total_steps >= max_steps:
                    break

            val_losses = []
            for _ in range(val_steps):
                idx = rng.integers(len(maps_val), size=2 * cfg.batch_size_val)
                s_idx = idx[: cfg.batch_size_val]
                t_idx = s_idx if cfg.same_subj else idx[cfg.batch_size_val:]
                si, ti = trainer.put_indices(s_idx, t_idx)
                # the row's dice_loss and grad_loss then come from the last
                # validation step, as in the JAX package (fault F10)
                aux = trainer.val_step_banked(gen, bank_val, si, ti)
                val_losses.append(float(aux["loss"]))

            sec_per_step = (time.time() - t0) / max(len(ep_losses), 1)
            row = dict(
                epoch=epoch + 1,
                loss=float(np.mean(ep_losses)) if ep_losses else float("nan"),
                dice_loss=float(aux["dice_loss"]),
                grad_loss=float(aux["grad_loss"]),
                val_loss=float(np.mean(val_losses)) if val_losses else float("nan"),
                sec_per_step=sec_per_step,
            )
            history.append(row)
            writer.writerow(list(row.values()))
            metrics_f.flush()
            if tb_writer is not None:
                for k in ("loss", "dice_loss", "grad_loss", "val_loss"):
                    tb_writer.add_scalar(k, row[k], global_step=epoch + 1)
                tb_writer.flush()
            if cfg.verbose:
                print(f"epoch {epoch + 1}/{cfg.epochs} loss={row['loss']:.4f} "
                      f"val={row['val_loss']:.4f} ({sec_per_step:.2f}s/step)", flush=True)

            if (epoch + 1) % cfg.save_freq == 0 or (epoch + 1) == cfg.epochs:
                trainer.save_checkpoint(os.path.join(model_dir, f"{epoch + 1:04d}"), epoch + 1)
            if max_steps is not None and total_steps >= max_steps:
                break

    trainer.save_checkpoint(os.path.join(model_dir, "final"), cfg.epochs)
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return {"history": history, "params": params, "steps": total_steps,
            "step_seconds": step_seconds, "trainer": trainer}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Train a SynthMorph model on images synthesized from label maps "
                    "(PyTorch, NVIDIA GPUs).")
    p.add_argument("--config-path", default="config/config.json")
    p.add_argument("--max-steps", type=int, default=None, help="optional step cap (debug)")
    p.add_argument("--device", default=None,
                   help="cuda (default: every card) or cpu, or a comma-separated list of the "
                        "data-parallel replicas' devices (cuda:0,cuda:1)")
    p.add_argument("--pool-tie", default="equal", choices=TIES,
                   help="tie rule of the max-pool backward (ops/pool.py)")
    arg = p.parse_args(argv)
    cfg = TrainConfig.from_json(arg.config_path)
    return run_training(cfg, max_steps=arg.max_steps, device=arg.device, pool_tie=arg.pool_tie)


if __name__ == "__main__":
    main()
