"""The dense diffeomorphic registration model (``vxm.networks.VxmDense``).

Counterpart of ``multimodal_registration_tpu/models/vxm_dense.py``: a U-Net
over ``concat(moving, fixed)`` gives features at ``1/svf_res`` resolution, a
3-channel 3³ float32 conv head emits the SVF, which is rescaled to
``1/int_res``, integrated by scaling and squaring, and used to warp the
moving image. When the integrated field is the half grid, the moved image
comes from kernel K3 (2x upsample fused into the warp).

Outputs: ``moved``, ``warp`` (the field at int-res, the reference
``predict()`` output), ``flow_fullres`` and ``svf``, all channels-last. The
trainer's loss reads neither ``moved`` nor, with ``grad_res`` 2,
``flow_fullres``; PyTorch removes no dead code, so ``forward`` takes
``with_moved=False`` / ``with_fullres=False`` to leave them out (``None``).

With ``cfg.quantize == "int8"`` the U-Net's wide convs run in int8 (kernel
K8) with the activation scales given by :meth:`VxmDense.set_quant_scales`,
flat ``{"unet/enc_1/amax": value}`` as the JAX package's sidecar names them;
built with ``quant_calibrate=True`` the model runs in full precision and
records each quantizable conv's running input ``max|x|``
(:meth:`VxmDense.recorded_scales`), as the JAX ``VxmDense(quant_calibrate=True)``
does into its ``"quant"`` collection (``models/quantize.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.models.unet import Unet, _ncdhw, _ndhwc
from multimodal_registration_torch.ops.field import smooth_field_batch
from multimodal_registration_torch.ops.integrate import integrate_svf_batch
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_batch, warp_up2x_batch


@dataclass(frozen=True)
class VxmConfig:
    """Network-architecture config; key names match ``config/config.json``
    and the JAX package's ``VxmConfig``."""

    enc: tuple = (64, 64, 64, 64)
    dec: tuple = (64, 64, 64, 64, 64, 64)
    int_steps: int = 5
    int_res: int = 2
    svf_res: int = 2
    compute_dtype: str = "bfloat16"
    # type of the gathered values inside scaling and squaring ("" = float32)
    integrate_payload_dtype: str = "bfloat16"
    # inference-time SVF smoothing (voxels of the SVF grid) before integration
    svf_smooth_sigma: float = 0.0
    # int8 inference ("" = off): the U-Net's wide convs run int8 x int8 -> int32
    # with calibrated activation scales (models/quantize.py); the flow head and
    # thin convs stay in the compute type. Inference only.
    quantize: str = ""

    @classmethod
    def from_json_dict(cls, d: dict) -> "VxmConfig":
        return cls(
            enc=tuple(d.get("enc", cls.enc)),
            dec=tuple(d.get("dec", cls.dec)),
            int_steps=int(d.get("int_steps", cls.int_steps)),
            int_res=int(d.get("int_res", cls.int_res)),
            svf_res=int(d.get("svf_res", cls.svf_res)),
            compute_dtype=str(d.get("compute_dtype", cls.compute_dtype)),
            integrate_payload_dtype=str(
                d.get("integrate_payload_dtype", cls.integrate_payload_dtype)
            ),
            svf_smooth_sigma=float(d.get("svf_smooth_sigma", cls.svf_smooth_sigma)),
            quantize=str(d.get("quantize", cls.quantize) or ""),
        )


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class VxmDense(nn.Module):
    """Inputs ``moving``/``fixed``: ``(B, X, Y, Z, 1)`` floats, spatial dims
    multiples of 16."""

    def __init__(self, cfg: VxmConfig = VxmConfig(), device=None, quant_calibrate: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = _torch_dtype(cfg.compute_dtype)
        self.payload_dtype = (_torch_dtype(cfg.integrate_payload_dtype)
                              if cfg.integrate_payload_dtype else None)
        nus = int(math.floor(math.log2(cfg.svf_res))) if cfg.svf_res > 1 else 0
        self.unet = Unet(2, cfg.enc, cfg.dec, nb_upsample_skips=nus,
                         dtype=self.dtype, device=device, quant=cfg.quantize)
        self.flow = nn.Conv3d(self.unet.out_channels, 3, 3, padding=1, device=device)
        with torch.no_grad():
            self.flow.weight.normal_(0.0, 1e-5)
            self.flow.bias.zero_()
        self.quant_calibrate = quant_calibrate

    def quant_blocks(self) -> dict:
        """Scale key (``unet/<block>/amax``) -> the quantizable ``ConvBlock``."""
        return {f"unet/{name}/amax": block for name, block in self.unet.named_children()
                if block.quantizable}

    @property
    def quant_calibrate(self) -> bool:
        return any(b.calibrating for b in self.quant_blocks().values())

    @quant_calibrate.setter
    def quant_calibrate(self, on: bool) -> None:
        for block in self.quant_blocks().values():
            block.calibrating, block.recorded = bool(on), None

    def set_quant_scales(self, scales) -> None:
        """Give the quantizable convs their activation scales (flat ``{key:
        amax}``; a conv without one raises when it runs; other keys are not
        read)."""
        for key, block in self.quant_blocks().items():
            block.amax = None if scales is None or key not in scales else float(
                np.float32(scales[key]))

    def recorded_scales(self) -> dict:
        """What calibration recorded so far, ``{key: numpy float32}``."""
        return {k: np.float32(b.recorded.item()) for k, b in self.quant_blocks().items()
                if b.recorded is not None}

    def forward(self, moving: torch.Tensor, fixed: torch.Tensor, impl=None,
                with_moved: bool = True, with_fullres: bool = True,
                pool_tie: str = "equal") -> dict:
        cfg = self.cfg
        inshape = tuple(moving.shape[1:4])
        if any(d % 16 for d in inshape):
            raise ValueError(
                f"spatial dims must be multiples of 16 (got {inshape}); the "
                "preprocessing pads to floor16 shapes")
        feat = self.unet(torch.cat([moving, fixed], dim=-1), impl=impl, pool_tie=pool_tie)

        # the flow head is float32; cuDNN would otherwise run it in TF32
        with full_fp32_convs():
            svf = _ndhwc(F.conv3d(_ncdhw(feat.float()), self.flow.weight,
                                  self.flow.bias, padding=1)).contiguous()

        svf_shape = tuple(int(round(d / cfg.svf_res)) for d in inshape)
        if tuple(svf.shape[1:4]) != svf_shape:
            f = svf_shape[0] / svf.shape[1]
            svf = torch.stack([rescale_field(v, f, out_shape=svf_shape) for v in svf])

        if cfg.svf_smooth_sigma > 0:
            svf = smooth_field_batch(svf, cfg.svf_smooth_sigma)

        int_shape = tuple(int(round(d / cfg.int_res)) for d in inshape)
        flow = svf
        if tuple(flow.shape[1:4]) != int_shape:
            f = int_shape[0] / flow.shape[1]
            flow = torch.stack([rescale_field(v, f, out_shape=int_shape) for v in flow])

        pos_flow = integrate_svf_batch(flow, cfg.int_steps, self.payload_dtype, impl=impl)

        if not (with_fullres or with_moved):
            flow_fullres = None
        elif tuple(pos_flow.shape[1:4]) != inshape:
            factors = tuple(i / c for i, c in zip(inshape, pos_flow.shape[1:4]))
            flow_fullres = torch.stack(
                [rescale_field(v, factors, out_shape=inshape) for v in pos_flow])
        else:
            flow_fullres = pos_flow

        if not with_moved:
            moved = None
        elif tuple(2 * d for d in pos_flow.shape[1:4]) == inshape:
            moved = warp_up2x_batch(moving.float(), pos_flow, impl=impl)
        else:
            moved = warp_batch(moving.float(), flow_fullres, interp="linear", impl=impl)
        return {"moved": moved, "warp": pos_flow, "flow_fullres": flow_fullres, "svf": svf}
