"""The registrar factory of the inference entry points.

Counterpart of ``multimodal_registration_tpu/infer/sharded.py::make_registrar``,
its single-device branch: the port runs on one GPU. A layout of more than
one device (``cfg.sharding`` with ``data * space > 1``) raises
``NotImplementedError`` naming ROADMAP item 15 (multi-GPU).
"""

from __future__ import annotations

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar


def make_registrar(cfg: InferenceConfig, params, max_batch: int = 4,
                   svf_smooth_sigma: float | None = None, quant_scales=None,
                   quant_sidecar: str | None = None, device=None) -> Registrar:
    """The :class:`Registrar` the inference config asks for, on ``device``
    (default: the GPU)."""
    data = int(cfg.sharding.get("data", 1) or 1)
    space = int(cfg.sharding.get("space", 1) or 1)
    if data * space > 1:
        raise NotImplementedError(
            f"sharding {{data: {data}, space: {space}}} is not ported yet (ROADMAP queue 1 "
            "item 15, multi-GPU)")
    return Registrar(cfg, params, max_batch=max_batch, device=device,
                     svf_smooth_sigma=svf_smooth_sigma, quant_scales=quant_scales,
                     quant_sidecar=quant_sidecar)
