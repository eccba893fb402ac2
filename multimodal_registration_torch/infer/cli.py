"""Pair-registration CLI (``3d_reg.py`` parity) of the port.

    python -m multimodal_registration_torch.infer.cli --model-path w.npz \\
        --config-path cfg.json --fx-img-path fx.nii.gz --mov-img-path mov.nii.gz

Same flags as ``multimodal_registration_tpu.infer.cli.pair_registration``
without the sharding flags, plus ``--device`` (default: the GPU).
"""

from __future__ import annotations

import argparse

import torch

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar, load_params_any, register


def _bool_flag(s: str) -> bool:
    return str(s).lower() in ("1", "true", "yes")


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
    p.add_argument("--one-cpu-tf", default="True",
                   help="pin host-side PyTorch work to one thread (sct_run_batch -jobs N)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    if _bool_flag(args.one_cpu_tf):
        torch.set_num_threads(1)

    cfg = InferenceConfig.from_json(args.config_path)
    if args.warp_interp:
        cfg.warp_interpolation = args.warp_interp
    if args.resample_interp:
        cfg.resample_interpolation = args.resample_interp
    params = load_params_any(args.model_path, cfg)
    reg = Registrar(cfg, params, device=args.device)
    return register(
        cfg, reg, args.fx_img_path, args.mov_img_path,
        fx_contrast=args.fx_img_contrast, naming="standalone", res_dir=args.res_dir,
        out_im_name=args.out_img_name, out_field_name=args.def_field_name,
    )


if __name__ == "__main__":
    pair_registration()
