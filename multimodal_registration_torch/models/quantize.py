"""int8 calibration of the registration model, and the scale sidecar.

Counterpart of ``multimodal_registration_tpu/models/quantize.py``. The
weights quantize on the fly from the float32 parameters (per output channel,
``ops/conv_int8.py``), so checkpoints do not change. Each quantizable conv
needs a per-tensor activation scale known before it runs: the running
``max|x|`` of its input over a few full-precision forwards, times a margin.
Scales are flat ``{"unet/enc_1/amax": value}`` and live in a JSON sidecar
beside the checkpoint, ``<model>.quant.json``, written and read in the JAX
package's format (the same bytes for the same scales).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense


def _as_quantized_cfg(cfg: VxmConfig) -> VxmConfig:
    return cfg if cfg.quantize == "int8" else dataclasses.replace(cfg, quantize="int8")


def _as_input(a, dev) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32)))
    t = t.to(device=dev, dtype=torch.float32)
    return t[None, ..., None] if t.ndim == 3 else t


def calibrate_scales(cfg: VxmConfig, model_or_params, pairs, margin: float = 1.25,
                     device=None, impl=None) -> dict:
    """Run the full-precision model over ``pairs`` and return the scales:
    each quantizable conv's input ``max|x|`` over all pairs, times
    ``margin``, in float32 (``{"unet/<block>/amax": numpy float32}``; empty
    when no conv is wide enough).

    ``model_or_params``: a :class:`VxmDense` of ``cfg`` with quantization on
    (used as it is, its scales untouched) or a state dict (a model is built
    on ``device``, default the GPU). ``pairs``: ``(moving, fixed)`` arrays or
    tensors shaped ``(B, X, Y, Z, 1)`` or ``(X, Y, Z)``. ``impl`` goes to the
    kernels the forward runs."""
    qcfg = _as_quantized_cfg(cfg)
    if isinstance(model_or_params, VxmDense) and model_or_params.cfg == qcfg:
        model = model_or_params
    else:
        params = (model_or_params.state_dict() if isinstance(model_or_params, torch.nn.Module)
                  else model_or_params)
        if device is None and isinstance(model_or_params, torch.nn.Module):
            device = next(model_or_params.parameters()).device
        model = VxmDense(qcfg, device=resolve_device(device)).eval()
        model.load_state_dict(params)
    dev = next(model.parameters()).device
    model.quant_calibrate = True
    try:
        seen = 0
        with torch.inference_mode():
            for mov, fx in pairs:
                model(_as_input(mov, dev), _as_input(fx, dev), impl=impl, with_moved=False,
                      with_fullres=False)
                seen += 1
        if not seen:
            raise ValueError("calibrate_scales needs at least one (moving, fixed) pair")
        recorded = model.recorded_scales()
    finally:
        model.quant_calibrate = False
    return {k: np.float32(v) * np.float32(margin) for k, v in recorded.items()}


def save_scales(path: str, quant: dict) -> None:
    """Write the scales (flat, ``{"unet/enc_1/amax": value}``) as the JSON
    sidecar."""
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in quant.items()}, f, indent=1, sort_keys=True)


def load_scales(path: str) -> dict:
    """Read a sidecar written by :func:`save_scales` (or by the JAX
    package's): ``{"unet/enc_1/amax": numpy float32}``."""
    with open(path) as f:
        return {k: np.float32(v) for k, v in json.load(f).items()}


def sidecar_path(model_path: str) -> str:
    return model_path + ".quant.json"


def maybe_load_sidecar(model_path: str, cfg) -> "dict | None":
    """The scales of a checkpoint, if ``<model_path>.quant.json`` exists and
    the config asks for quantization; None otherwise (the registrars then
    calibrate on the first predicted chunk)."""
    p = sidecar_path(model_path)
    if str(getattr(cfg, "quantize", "") or "") and os.path.exists(p):
        return load_scales(p)
    return None


def sidecar_kwargs(model_path: str, cfg) -> dict:
    """``Registrar`` arguments of the sidecar contract: the scales when
    ``<model>.quant.json`` exists, and that path for the lazy calibration to
    write them to otherwise (paid once per checkpoint, not once per
    process). Empty when the config does not quantize."""
    if not str(getattr(cfg, "quantize", "") or ""):
        return {}
    return {"quant_scales": maybe_load_sidecar(model_path, cfg),
            "quant_sidecar": sidecar_path(model_path)}
