"""Attribution of the two-step cascade's folding to its fields and compositions.

    python -m multimodal_registration_torch.tools.cascade_folding_probe [--quick]
        [--subject-idx I] [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/cascade_folding_probe.py``. One subject
of the two-step artifact's construction (:func:`subject`: label maps seed 888,
the fixed and moving images synthesised from map ``i`` with generators seeded
9000 + 2i and 9000 + 2i + 1, the moving one displaced by a large rigid
transform, ``rigid_displace`` seed 500 + i, both min-max scaled) goes through
``Registrar.predict`` on ``learned_model1`` (step 1, smooth) and then
``learned_ref`` (step 2, fine). The port's synthesis and generators make the
subject, so it is the port's sub-02, not the JAX package's. Folding of each
field, measured as the evaluator does (:func:`export_fold`: the field
exported to RAI flips its first two components, then
``evalx/jacobian.py::folding_summary``'s ``percentage_negative_detJa``):

* ``warp1_only`` / ``warp2_only``: each step's int-res field, upsampled;
* ``int_compose``: the reference's semantics, ``ops/field.py::compose_fields``
  at the int grid, then upsampled (``rescale_field``);
* ``int_compose_numpy_vxm_check``: the same composition by
  :func:`numpy_compose`, VoxelMorph's ``compose`` in float64 numpy
  (edge-clamped linear interpolation), independent of the port's warp;
* ``full_compose``: both fields upsampled first, composed on the image grid
  (``infer/cascade.py::_compose_full``, the ``cascade_compose_res='full'``
  default).

The record has the JAX script's keys (``workload``, ``checkpoints``,
``mean_abs_flow_vox``, ``folding_pct_exported``), printed as indented JSON
and written to ``--out`` (never under ``benchmarks/``). ``--quick``: 48^3, 8
labels, enc/dec [4] with zero weights, float32. Otherwise the in-repo
checkpoints at 160x160x192, 26 labels, the config's bf16 compute. Either runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.evalx.jacobian import folding_summary
from multimodal_registration_torch.infer.cascade import _compose_full
from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar, load_params_any
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.ops.field import compose_fields
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.synth.image_engine import labels_to_image
from multimodal_registration_torch.synth.labelmaps import generate_label_maps
from multimodal_registration_torch.tools.pipeline_quality import rigid_displace
from multimodal_registration_torch.tools.timing import (
    BENCHMARKS, card_note, note, write_result)
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import engine_config_from

CKPT2 = os.path.join(BENCHMARKS, "learned_ref_160x160x192_26lab.npz")  # fine
CKPT1 = os.path.join(BENCHMARKS, "learned_model1_160x160x192_26lab.npz")  # smooth
SHAPE, NUM_LABELS = (160, 160, 192), 26
QUICK_SHAPE, QUICK_LABELS = (48, 48, 48), 8
MAPS_SEED, IMAGE_SEED, DISPLACE_SEED = 888, 9000, 500
FLIP = np.array([-1.0, -1.0, 1.0], np.float32)  # the RAI export of an identity affine


def numpy_compose(phi1, phi2):
    """Pure-numpy ``vxm.utils.compose`` semantics: phi2 + lin_interp(phi1) at
    (grid + phi2), edge-clamped — independent of the port's ops.warp."""
    X, Y, Z, _ = phi1.shape
    grid = np.stack(
        np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"), -1
    ).astype(np.float64)
    loc = grid + phi2
    maxs = np.array([X - 1, Y - 1, Z - 1], np.float64)
    loc = np.clip(loc, 0.0, maxs)
    l0 = np.floor(loc)
    w = loc - l0
    i0 = l0.astype(np.int64)
    i1 = np.minimum(i0 + 1, maxs.astype(np.int64))
    out = np.zeros_like(phi1, np.float64)
    for dx in (0, 1):
        wx = w[..., 0] if dx else 1 - w[..., 0]
        ix = i1[..., 0] if dx else i0[..., 0]
        for dy in (0, 1):
            wy = w[..., 1] if dy else 1 - w[..., 1]
            iy = i1[..., 1] if dy else i0[..., 1]
            for dz in (0, 1):
                wz = w[..., 2] if dz else 1 - w[..., 2]
                iz = i1[..., 2] if dz else i0[..., 2]
                out += phi1[ix, iy, iz] * (wx * wy * wz)[..., None]
    return phi2 + out


def _host(field) -> np.ndarray:
    return field.float().cpu().numpy() if isinstance(field, torch.Tensor) else np.asarray(field)


def export_fold(field, device=None) -> float:
    """Folding % of the RAI-exported field (identity affine: the export flips
    the first two components, ``bids_registration.py:403-421``)."""
    s = folding_summary(_host(field) * FLIP, device=device)
    return round(s["percentage_negative_detJa"], 4)


def train_config(quick: bool) -> TrainConfig:
    if quick:
        return TrainConfig.from_dict(dict(
            in_shape=list(QUICK_SHAPE), num_labels=QUICK_LABELS, num_maps=2, im_scales=[8],
            def_scales=[8], enc=[4] * 4, dec=[4] * 6, compute_dtype="float32", epochs=1))
    return TrainConfig.from_dict(dict(in_shape=list(SHAPE), num_labels=NUM_LABELS, num_maps=2,
                                      batch_size=1, epochs=1))


def inference_config(tcfg: TrainConfig, compute_dtype: str | None = None) -> InferenceConfig:
    d = dict(enc=list(tcfg.enc), dec=list(tcfg.dec), int_steps=tcfg.int_steps,
             int_res=tcfg.int_res, svf_res=tcfg.svf_res)
    if compute_dtype:
        d["compute_dtype"] = compute_dtype
    return InferenceConfig.from_dict(d)


@torch.no_grad()
def subject(i: int, tcfg: TrainConfig, device) -> dict:
    """The artifact's subject ``i`` (``twostep_parity_run.py``'s construction):
    ``fx``, ``mov`` (min-max scaled float32 host arrays), ``lab`` (the fixed
    labels) and ``mov_lab`` (the labels under the moving image's displacement)."""
    dev = resolve_device(device)
    shape = tuple(tcfg.in_shape)
    maps = generate_label_maps(torch.Generator(device=dev).manual_seed(MAPS_SEED), i + 1, shape,
                               tcfg.num_labels, device=dev, im_scales=tcfg.im_scales,
                               def_scales=tcfg.def_scales)
    engine_cfg = engine_config_from(tcfg)
    lab = torch.as_tensor(maps[i], device=dev)

    def image(seed):
        img, _ = labels_to_image(lab, engine_cfg,
                                 gen=torch.Generator(device=dev).manual_seed(seed))
        return img.float().cpu().numpy()

    fx = image(IMAGE_SEED + 2 * i)
    mov = image(IMAGE_SEED + 2 * i + 1)
    lab_np = np.asarray(maps[i])
    mov, mov_lab = rigid_displace(mov, lab_np, DISPLACE_SEED + i)
    fx = (fx - fx.min()) / max(fx.max() - fx.min(), 1e-9)
    mov = (mov - mov.min()) / max(mov.max() - mov.min(), 1e-9)
    return {"fx": fx.astype(np.float32), "mov": mov.astype(np.float32), "lab": lab_np,
            "mov_lab": mov_lab}


def zero_weights(cfg: InferenceConfig) -> dict:
    """A state dict of zeros at ``cfg``'s widths (the JAX ``params_template``)."""
    vcfg = VxmConfig(enc=tuple(cfg.enc), dec=tuple(cfg.dec), compute_dtype=cfg.compute_dtype)
    return {k: torch.zeros_like(v) for k, v in VxmDense(vcfg, device="cpu").state_dict().items()}


def registrars(quick: bool, cfg: InferenceConfig, device) -> tuple:
    """``(reg1, reg2, names)``: step 1 and step 2 on ``device``."""
    if quick:
        params = zero_weights(cfg)
        return (Registrar(cfg, params, device=device), Registrar(cfg, params, device=device),
                {"model1": "zero template", "model2": "zero template"})
    return (Registrar(cfg, load_params_any(CKPT1, cfg), device=device),
            Registrar(cfg, load_params_any(CKPT2, cfg), device=device),
            {"model1": os.path.basename(CKPT1), "model2": os.path.basename(CKPT2)})


@torch.inference_mode()
def probe(reg1: Registrar, reg2: Registrar, fx: np.ndarray, mov: np.ndarray, device=None) -> dict:
    """``mean_abs_flow_vox`` and ``folding_pct_exported`` of the cascade on
    one pair (host arrays ``(X, Y, Z)``)."""
    shape = tuple(fx.shape)
    moved1_b, warp1_b = reg1.predict_tensors(mov[None], fx[None])
    _, warp2_b = reg2.predict_tensors(moved1_b[0][None], fx[None])
    warp1, warp2 = warp1_b[0], warp2_b[0]
    scale = 1 if warp1.shape[0] == shape[0] else 2

    def up(w):  # upsample AND scale the vectors to full-res units
        return rescale_field(w, scale, out_shape=shape) if scale != 1 else w

    comp_int = compose_fields(warp1, warp2, impl=reg1.impl)
    comp_np = numpy_compose(_host(warp1).astype(np.float64),
                            _host(warp2).astype(np.float64)).astype(np.float32)
    comp_np_full = up(torch.as_tensor(comp_np, device=warp1.device))
    comp_full = _compose_full(warp1, warp2, scale, shape, impl=reg1.impl)
    return {
        "mean_abs_flow_vox": {
            "warp1(at int-res grid)": round(float(warp1.abs().mean()), 3),
            "warp2(at int-res grid)": round(float(warp2.abs().mean()), 3),
        },
        "folding_pct_exported": {
            "warp1_only": export_fold(up(warp1), device),
            "warp2_only": export_fold(up(warp2), device),
            "int_compose(reference semantics)": export_fold(up(comp_int), device),
            "int_compose_numpy_vxm_check": export_fold(comp_np_full, device),
            "full_compose(round-4 default)": export_fold(comp_full, device),
        },
    }


def run(quick: bool = False, subject_idx: int = 1, device=None) -> dict:
    dev = resolve_device(device)
    tcfg = train_config(quick)
    shape, L = tuple(tcfg.in_shape), tcfg.num_labels
    cfg = inference_config(tcfg, "float32" if quick else None)
    reg1, reg2, names = registrars(quick, cfg, dev)
    sub = subject(subject_idx, tcfg, dev)
    i = subject_idx
    return {"workload": f"{shape}/{L} labels, subject idx {i} (sub-{i + 1:02d}), "
                        f"rigid-displaced moving",
            "checkpoints": names, **probe(reg1, reg2, sub["fx"], sub["mov"], dev)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--subject-idx", type=int, default=1, help="0-based; 1 = sub-02")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    out = run(a.quick, a.subject_idx, dev)
    write_result(a.out, out)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
