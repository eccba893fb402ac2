"""Inference CLIs of the port, drop-in equivalents of the JAX package's
(``multimodal_registration_tpu/infer/cli.py``), plus ``--device`` (default:
the GPU; ``cpu`` runs on the CPU; a comma-separated list names the devices
of a sharded layout in order, e.g. ``cuda:0,cuda:1``):

  * :func:`pair_registration` (``3d_reg.py``)::

        python -m multimodal_registration_torch.infer.cli --model-path w.npz \\
            --config-path cfg.json --fx-img-path fx.nii.gz --mov-img-path mov.nii.gz

  * :func:`bids_registration` (``bids_registration.py``),
    :func:`bids_two_steps` (``bids_two_steps_registration.py``),
    :func:`gen_apply_def_field` (``gen_apply_def_field.py``) and
    :func:`quant_calibrate` (the JAX package's ``mmreg-calibrate``), reached
    through ``python -m multimodal_registration_torch <command>``.

``--space N`` shards each volume's X axis over N devices and
``--data-shard N`` the batch (they override the config's ``sharding``);
every registrar comes from ``infer/sharded.py::make_registrar``.

With ``quantize: "int8"`` in the config, every registrar reads the int8
scales from ``<model>.quant.json`` or calibrates them on its first pair and
writes that file (``models/quantize.py::sidecar_kwargs``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.infer.cascade import register_two_steps
from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import (
    load_params_any, register, vxm_config_from)
from multimodal_registration_torch.infer.sharded import make_registrar
from multimodal_registration_torch.models.quantize import sidecar_kwargs
from multimodal_registration_torch.utils import io as vio
from multimodal_registration_torch.utils import nifti


def _bool_flag(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes")


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument("--one-cpu-tf", default="True",
                   help="pin host-side PyTorch work to one thread (sct_run_batch -jobs N)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; pass cpu to run on the CPU)")


def _add_sharding_flags(p: argparse.ArgumentParser):
    p.add_argument("--space", type=int, default=None,
                   help="shard the volume X-axis over N chips (multi-chip "
                        "inference; overrides the config's sharding.space). The chips: "
                        "every card, or those --device lists (cuda:0,cuda:1; one may repeat)")
    p.add_argument("--data-shard", type=int, default=None,
                   help="shard the batch axis over N chips (overrides the "
                        "config's sharding.data)")


def _apply_sharding_flags(cfg: InferenceConfig, args):
    if getattr(args, "space", None):
        cfg.sharding = {**cfg.sharding, "space": args.space}
    if getattr(args, "data_shard", None):
        cfg.sharding = {**cfg.sharding, "data": args.data_shard}


def _maybe_one_cpu(flag: str):
    if _bool_flag(flag):
        torch.set_num_threads(1)


def pair_registration(argv=None):
    p = argparse.ArgumentParser(description="Register a pair of 3-D volumes (3d_reg parity).")
    p.add_argument("--model-path", required=True)
    p.add_argument("--config-path", required=True)
    p.add_argument("--fx-img-path", required=True)
    p.add_argument("--mov-img-path", required=True)
    p.add_argument("--fx-img-contrast", default="T1w")
    p.add_argument("--res-dir", default="res")
    p.add_argument("--out-img-name", default="warped_im")
    p.add_argument("--def-field-name", default="deform_field")
    p.add_argument("--warp-interp", default=None,
                   help="override warp interpolation (linear/nearest)")
    p.add_argument("--resample-interp", default=None,
                   help="override resample interpolation (linear/nearest/spline)")
    _add_common_flags(p)
    _add_sharding_flags(p)
    args = p.parse_args(argv)
    _maybe_one_cpu(args.one_cpu_tf)

    cfg = InferenceConfig.from_json(args.config_path)
    if args.warp_interp:
        cfg.warp_interpolation = args.warp_interp
    if args.resample_interp:
        cfg.resample_interpolation = args.resample_interp
    _apply_sharding_flags(cfg, args)
    params = load_params_any(args.model_path, cfg)
    reg = make_registrar(cfg, params, device=args.device, **sidecar_kwargs(args.model_path, cfg))
    return register(
        cfg, reg, args.fx_img_path, args.mov_img_path,
        fx_contrast=args.fx_img_contrast, naming="standalone", res_dir=args.res_dir,
        out_im_name=args.out_img_name, out_field_name=args.def_field_name,
    )


def bids_registration(argv=None):
    p = argparse.ArgumentParser(
        description="BIDS single-model registration (bids_registration parity).")
    p.add_argument("--model-path", required=True)
    p.add_argument("--config-path", required=True)
    p.add_argument("--fx-img-path", required=True)
    p.add_argument("--mov-img-path", required=True)
    p.add_argument("--fx-img-contrast", default="T1w")
    _add_common_flags(p)
    _add_sharding_flags(p)
    args = p.parse_args(argv)
    _maybe_one_cpu(args.one_cpu_tf)

    cfg = InferenceConfig.from_json(args.config_path)
    _apply_sharding_flags(cfg, args)
    reg = make_registrar(cfg, load_params_any(args.model_path, cfg), device=args.device,
                         **sidecar_kwargs(args.model_path, cfg))
    return register(cfg, reg, args.fx_img_path, args.mov_img_path,
                    fx_contrast=args.fx_img_contrast, naming="bids")


def bids_two_steps(argv=None):
    p = argparse.ArgumentParser(description="BIDS two-step cascade registration.")
    p.add_argument("--model1-path", required=True)
    p.add_argument("--model2-path", required=True)
    p.add_argument("--config-path", required=True)
    p.add_argument("--fx-img-path", required=True)
    p.add_argument("--mov-img-path", required=True)
    p.add_argument("--fx-img-contrast", default="T1w")
    _add_common_flags(p)
    _add_sharding_flags(p)
    args = p.parse_args(argv)
    _maybe_one_cpu(args.one_cpu_tf)

    cfg = InferenceConfig.from_json(args.config_path)
    _apply_sharding_flags(cfg, args)
    reg1 = make_registrar(cfg, load_params_any(args.model1_path, cfg), device=args.device,
                          svf_smooth_sigma=cfg.model1_svf_smooth_sigma,
                          **sidecar_kwargs(args.model1_path, cfg))
    reg2 = make_registrar(cfg, load_params_any(args.model2_path, cfg), device=args.device,
                          **sidecar_kwargs(args.model2_path, cfg))
    return register_two_steps(cfg, reg1, reg2, args.fx_img_path, args.mov_img_path,
                              fx_contrast=args.fx_img_contrast)


def quant_calibrate(argv=None):
    """Calibrate the int8 activation scales of a checkpoint and write its
    ``<model>.quant.json`` sidecar (``models/quantize.py``). The pairs go
    through the inference preprocessing, subvolume tiles included when the
    config asks for them, so the scales are those of what the int8
    registrar will see. Prints and returns the sidecar's path."""
    from multimodal_registration_torch.infer.preprocess import preprocess
    from multimodal_registration_torch.models import quantize as qmod

    p = argparse.ArgumentParser(
        description="Write the int8 activation-scale sidecar for a checkpoint.")
    p.add_argument("--model-path", required=True)
    p.add_argument("--config-path", required=True)
    p.add_argument("--pair", action="append", required=True,
                   metavar="FIXED.nii.gz,MOVING.nii.gz",
                   help="calibration pair (repeatable; 1-3 representative pairs are plenty: "
                        "the scales are per-tensor running maxima)")
    p.add_argument("--out", default=None,
                   help="sidecar path (default: <model-path>.quant.json)")
    p.add_argument("--margin", type=float, default=1.25,
                   help="headroom factor on the recorded maxima")
    _add_common_flags(p)
    args = p.parse_args(argv)
    _maybe_one_cpu(args.one_cpu_tf)

    cfg = InferenceConfig.from_json(args.config_path)
    if not (cfg.quantize or ""):
        cfg.quantize = "int8"  # calibration implies the int8 layout
    params = load_params_any(args.model_path, cfg)
    dev = resolve_device(args.device)

    pairs = []
    for spec in args.pair:
        parts = spec.split(",")
        if len(parts) != 2:
            raise SystemExit(
                f"--pair wants FIXED,MOVING (two comma-separated paths), got: {spec!r}")
        pre = preprocess(cfg, nifti.load(parts[0]), nifti.load(parts[1]), device=dev)
        if cfg.use_subvol:
            pairs.extend((np.asarray(m, np.float32)[None, ..., None],
                          np.asarray(f, np.float32)[None, ..., None])
                         for m, f in zip(pre.subvols_mov, pre.subvols_fx))
        else:
            pairs.append((pre.moving.get_fdata()[None, ..., None],
                          pre.fixed.get_fdata()[None, ..., None]))

    quant = qmod.calibrate_scales(vxm_config_from(cfg), params, pairs, margin=args.margin,
                                  device=dev)
    if not quant:
        raise SystemExit(
            "no quantizable conv at these widths (every conv input is thinner than the int8 "
            "threshold) — nothing to calibrate; int8 only pays at the published enc-256 widths")
    out = args.out or qmod.sidecar_path(args.model_path)
    qmod.save_scales(out, quant)
    print(out)
    return out


@torch.inference_mode()
def gen_apply_def_field(argv=None):
    """Draw a Perlin deformation field and apply it to a volume
    (``gen_apply_def_field.py`` parity)."""
    from multimodal_registration_torch.ops.warp import warp as device_warp
    from multimodal_registration_torch.synth.perlin import draw_perlin

    p = argparse.ArgumentParser(
        description="Deform an image with a generated deformation field. The field is drawn "
                    "by a seeded torch.Generator, so for a given --seed it differs from the "
                    "field the JAX package draws (another random number generator); its "
                    "statistics (scales, standard deviations) are the same.")
    p.add_argument("--im-path", required=True)
    p.add_argument("--res-dir", default="res")
    p.add_argument("--out-im-name", default="moved_im")
    p.add_argument("--out-def-name", default="deformation_field")
    p.add_argument("--def-scales", type=int, nargs="+", default=[16, 32, 64])
    p.add_argument("--def-max-std", type=float, default=3)
    p.add_argument("--interp", default="linear")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the torch.Generator; default random per invocation "
                        "(reference parity). Not the JAX package's field for the same seed")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    if args.seed is None:
        args.seed = int.from_bytes(os.urandom(4), "little")
    dev = resolve_device(args.device)

    img = nifti.load(args.im_path)
    os.makedirs(args.res_dir, exist_ok=True)
    shape = img.shape[:3]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    field = draw_perlin(gen, (*shape, 1, 3), scales=args.def_scales, max_std=args.def_max_std,
                        device=dev)[..., 0, :]
    out_def_path = os.path.join(args.res_dir, f"{args.out_def_name}.nii.gz")
    nifti.save(nifti.NiftiImage(field.cpu().numpy(), img.affine), out_def_path)

    vol = torch.as_tensor(np.asarray(img.get_fdata(), np.float32), device=dev)
    moved = device_warp(vol, field, interp=args.interp).cpu().numpy()
    out_im_path = os.path.join(args.res_dir, f"{args.out_im_name}.nii.gz")
    vio.save_volfile(moved, out_im_path, img.affine)
    return {"def_field": out_def_path, "moved": out_im_path}


if __name__ == "__main__":
    pair_registration()
