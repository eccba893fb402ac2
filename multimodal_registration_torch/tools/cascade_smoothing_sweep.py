"""Step-1 SVF smoothing sweep of the two-step cascade: folding and Dice per sigma.

    python -m multimodal_registration_torch.tools.cascade_smoothing_sweep
        [--subject-idx I] [--sigmas S ...] [--tpu] [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/cascade_smoothing_sweep.py``, on the
subject of ``tools/cascade_folding_probe.py`` (160x160x192, 26 labels, the
in-repo ``learned_model1`` then ``learned_ref``). Step 1's SVF is computed
once (``VxmDense``'s ``"svf"``); for each sigma it is smoothed by the
production operator, ``ops/field.py::smooth_field(svf, sigma, radius=9)``
(border-renormalised separable Gaussian, sigma in voxels of the SVF grid,
the code ``VxmConfig.svf_smooth_sigma`` runs), and integrated
(``integrate_svf``, K2's fused step). The moving volume is warped (linear,
K2) by the upsampled field (``rescale_field``), step 2 (``predict``) runs on
it, and the compositions ``int`` (at the int grid, then upsampled) and
``full`` (on the image grid) are formed (``compose_fields``, K2). A row:

* ``fold_warp1_only``, ``fold_int_compose``, ``fold_full_compose``: the
  exported fields' folding (``cascade_folding_probe.export_fold``);
* ``fold_warp1_interior16``, ``fold_int_compose_interior16``: the same
  without a 16-voxel border (:func:`interior_fold`);
* ``dice_int_compose``, ``dice_full_compose``, ``dice_step1_only``: the
  displaced moving labels warped (nearest, K2) by the field against the fixed
  subject's labels, the mean Dice over labels 1..L-1 present
  (:func:`label_dice`): the guard that smoothing costs no registration quality;
* ``sigma_vox_at_svf_grid``, ``mean_abs_warp1_vox``.

One JSON line a row, then the record (the JAX script's ``workload``,
``backend``, ``checkpoints``, ``blur`` and ``rows``) to ``--out`` (never under
``benchmarks/``). Arithmetic: on the card the config's bf16 compute with a
bf16 integration payload, what the JAX script's ``--tpu`` selects; with
``--device cpu`` float32 throughout, the JAX script's default. ``--tpu`` is
accepted, so that the JAX script's command lines run, and changes nothing:
the device decides the arithmetic. Runs on the card unless ``--device cpu``.
:func:`run`'s ``quick`` takes the folding probe's ``--quick`` configuration
(48^3, 8 labels, enc/dec [4] with zero weights, float32) for a rehearsal.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.evalx.jacobian import folding_summary
from multimodal_registration_torch.infer.cascade import _compose_full
from multimodal_registration_torch.infer.register import Registrar
from multimodal_registration_torch.ops.field import compose_fields, smooth_field
from multimodal_registration_torch.ops.integrate import integrate_svf
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp
from multimodal_registration_torch.tools import cascade_folding_probe as cfp
from multimodal_registration_torch.tools.learn_check import mean_label_dice
from multimodal_registration_torch.tools.timing import card_note, note, write_result

SIGMAS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0)
RADIUS = 9  # static kernel width; covers sigma <= 3 (tail < 1e-4)
MARGIN = 16


def interior_fold(field, margin: int = MARGIN, device=None) -> float:
    """Folding % excluding a ``margin``-voxel border (is the folding an edge
    effect or in the bulk?)."""
    f = cfp._host(field) * cfp.FLIP
    m = margin
    s = folding_summary(f[m:-m, m:-m, m:-m], device=device)
    return round(s["percentage_negative_detJa"], 4)


def label_dice(mov_lab: torch.Tensor, lab: torch.Tensor, field: torch.Tensor,
               num_labels: int, impl=None) -> float:
    """Mean Dice over the non-background labels: ``mov_lab`` warped (nearest)
    by the full-res ``field`` against ``lab``."""
    moved = warp(mov_lab.float(), field, interp="nearest", impl=impl).round().to(torch.int64)
    return round(mean_label_dice(moved, lab, num_labels), 4)


@torch.inference_mode()
def sweep_rows(reg1: Registrar, reg2: Registrar, sub: dict, num_labels: int, sigmas=SIGMAS,
               payload_dtype=None, emit=print) -> list:
    """One row per sigma on the subject ``sub`` (:func:`cascade_folding_probe.subject`),
    on ``reg1``'s device."""
    dev = reg1.device
    fx, mov = sub["fx"], sub["mov"]
    shape = tuple(fx.shape)
    impl = reg1.impl
    mov_t = torch.as_tensor(mov, device=dev)
    fx_t = torch.as_tensor(fx, device=dev)
    lab = torch.as_tensor(np.asarray(sub["lab"], np.int64), device=dev)
    mov_lab = torch.as_tensor(np.asarray(sub["mov_lab"], np.int64), device=dev)
    # step 1's SVF once (sigma-independent): the model's raw half-res flow
    svf1 = reg1.model(mov_t[None, ..., None], fx_t[None, ..., None], impl=impl)["svf"][0]

    def up(w):
        return rescale_field(w, 2, out_shape=shape)

    rows = []
    for sigma in sigmas:
        w1 = integrate_svf(smooth_field(svf1, float(sigma), radius=RADIUS),
                           reg1.cfg.int_steps, payload_dtype=payload_dtype, impl=impl)
        moved1 = warp(mov_t, up(w1), interp="linear", impl=impl)
        _, w2_b = reg2.predict_tensors(moved1[None], fx_t[None])
        w2 = w2_b[0]
        ci = compose_fields(w1, w2, impl=impl)
        cf = _compose_full(w1, w2, 2, shape, impl=impl)
        w1_full, ci_full = up(w1), up(ci)
        row = {
            "sigma_vox_at_svf_grid": sigma,
            "mean_abs_warp1_vox": round(float(w1.abs().mean()), 3),
            "fold_warp1_only": cfp.export_fold(w1_full, dev),
            "fold_warp1_interior16": interior_fold(w1_full, device=dev),
            "fold_int_compose": cfp.export_fold(ci_full, dev),
            "fold_int_compose_interior16": interior_fold(ci_full, device=dev),
            "fold_full_compose": cfp.export_fold(cf, dev),
            "dice_int_compose": label_dice(mov_lab, lab, ci_full, num_labels, impl),
            "dice_full_compose": label_dice(mov_lab, lab, cf, num_labels, impl),
            "dice_step1_only": label_dice(mov_lab, lab, w1_full, num_labels, impl),
        }
        rows.append(row)
        emit(json.dumps(row))
    return rows


def run(subject_idx: int = 1, sigmas=SIGMAS, device=None, emit=print,
        quick: bool = False) -> dict:
    dev = resolve_device(device)
    bf16 = dev.type == "cuda" and not quick
    tcfg = cfp.train_config(quick)
    shape, L = tuple(tcfg.in_shape), tcfg.num_labels
    cfg = cfp.inference_config(tcfg, "bfloat16" if bf16 else "float32")
    reg1, reg2, names = cfp.registrars(quick, cfg, dev)
    sub = cfp.subject(subject_idx, tcfg, dev)
    rows = sweep_rows(reg1, reg2, sub, L, sigmas, torch.bfloat16 if bf16 else None, emit)
    i = subject_idx
    return {"workload": f"{shape}/{L} labels, subject idx {i} (sub-{i + 1:02d}), "
                        f"rigid-displaced moving",
            "backend": f"{dev.type}-{'bf16' if bf16 else 'f32'}",
            "checkpoints": names,
            "blur": f"border-renormalized separable Gaussian, radius {RADIUS}",
            "rows": rows}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subject-idx", type=int, default=1, help="0-based; 1 = sub-02")
    ap.add_argument("--sigmas", type=float, nargs="+",
                    default=[0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
    ap.add_argument("--tpu", action="store_true",
                    help="accepted and ignored: bf16 on the card, float32 with --device cpu")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    out = run(a.subject_idx, a.sigmas, dev)
    write_result(a.out, out)
    if a.out:
        print("wrote", a.out)
    return out


if __name__ == "__main__":
    main()
