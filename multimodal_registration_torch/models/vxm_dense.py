"""The dense diffeomorphic registration model (``vxm.networks.VxmDense``).

Counterpart of ``multimodal_registration_tpu/models/vxm_dense.py``: a U-Net
over ``concat(moving, fixed)`` gives features at ``1/svf_res`` resolution, a
3-channel 3³ float32 conv head (kernel K9 on the card) emits the SVF, which
is rescaled to ``1/int_res``, integrated by scaling and squaring, and used to
warp the moving image. When the integrated field is the half grid, the moved image
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

In a forward captured as CUDA graphs (``utils/graphs.py``) the U-Net, the
head, the rescale and smoothing, the integration and the outputs are its
segments, each inside the call that runs it eager; the concatenation of
``moving`` and ``fixed`` goes into the key's buffer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.models.unet import Unet, _ncdhw, _ndhwc
from multimodal_registration_torch.ops.bias_lrelu import DTYPES as BIAS_LRELU_DTYPES
from multimodal_registration_torch.ops.field import smooth_field_batch
from multimodal_registration_torch.ops.flow_head import flow_head_conv
from multimodal_registration_torch.ops.integrate import integrate_svf_batch
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import use_kernel, warp_batch, warp_up2x_batch
from multimodal_registration_torch.utils import graphs
from multimodal_registration_torch.utils.profiling import span


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
    multiples of 16. :meth:`forward` is :meth:`tail` of :meth:`flow_head` of
    the U-Net's features; the sharded forward (``parallel/spatial.py``) runs
    the U-Net and the head on X slabs and the tail on the whole field."""

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
        self.quant_version = 0  # goes up with each set_quant_scales

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
        self.quant_version += 1

    def recorded_scales(self) -> dict:
        """What calibration recorded so far, ``{key: numpy float32}``."""
        return {k: np.float32(b.recorded.item()) for k, b in self.quant_blocks().items()
                if b.recorded is not None}

    def kernel_launches(self, slabs: int = 1, with_moved: bool = True) -> dict:
        """What one inference :meth:`forward` launches on the card, its U-Net
        and head on ``slabs`` X slabs (``parallel/spatial.py``): by kernel,
        every one of ``kernels.KERNELS``, and by C entry, those launched. K1
        runs enc_0 when the decoder skips its full resolution; K8 each
        quantizable conv out of calibration; K11 each other conv, the library's
        (in bf16 or float32). ``with_moved=False``: a forward that makes no
        moved image, so neither K3 nor K2's general warp."""
        unet, steps = self.unet, self.cfg.int_steps
        half = int(self.cfg.int_res == 2)
        moved = int(with_moved)
        fused_first = unet.nb_upsample_skips >= 1
        int8 = not self.quant_calibrate
        k1 = slabs * int(fused_first)
        k8 = slabs * int8 * len(self.quant_blocks())
        k10 = slabs * max(0, min(len(unet.dec_nf), len(unet.enc_nf) - unet.nb_upsample_skips))
        library = [name for name, block in unet.named_children()
                   if not (name == "enc_0" and fused_first or block.quantizable and int8)]
        k11 = slabs * len(library) * int(unet.dtype in BIAS_LRELU_DTYPES)
        counts = dict.fromkeys((k.name for k in kernels.KERNELS), 0)
        counts.update(conv3_lrelu_pool=k1, warp_trilinear=steps + moved * (1 - half),
                      warp_up2x=moved * half, conv3_int8=k8, flow_head=slabs, up_cat=k10,
                      bias_lrelu=k11)
        entries = {"conv3_lrelu_pool_launch": k1, "self_warp_add_launch": steps,
                   "warp_launch": moved * (1 - half), "warp_up2x_launch": moved * half,
                   "conv3_int8_launch": k8,
                   "flow_head_fwd_launch": slabs, "up_cat_launch": k10, "bias_lrelu_launch": k11}
        return {**counts, **{e: n for e, n in entries.items() if n}}

    def forward(self, moving: torch.Tensor, fixed: torch.Tensor, impl=None,
                with_moved: bool = True, with_fullres: bool = True,
                pool_tie: str = "equal") -> dict:
        inshape = tuple(moving.shape[1:4])
        if any(d % 16 for d in inshape):
            raise ValueError(
                f"spatial dims must be multiples of 16 (got {inshape}); the "
                "preprocessing pads to floor16 shapes")
        x = graphs.static_cat("x", [moving, fixed], -1)
        with span("vxm.unet"):
            feat = self.unet(x, impl=impl, pool_tie=pool_tie)
        return self.tail(moving, self.flow_head(feat, impl=impl), impl=impl,
                         with_moved=with_moved, with_fullres=with_fullres)

    def flow_head(self, feat: torch.Tensor, impl=None) -> torch.Tensor:
        """The float32 3³ SAME conv from the U-Net's features to the SVF
        ``(B, x, y, z, 3)``: on the card kernel K9 (``ops/flow_head.py``, forward
        and both gradients), reading the features as they are; on the CPU, or
        with ``impl="plain"``, the library conv on ``feat.float()`` in full
        float32 (cuDNN would otherwise run it in TF32)."""
        with span("vxm.flow_head"):
            return graphs.segment("flow_head", self._flow_head, feat, impl)

    def _flow_head(self, feat, impl):
        if use_kernel(feat, impl):
            return flow_head_conv(feat, self.flow.weight, self.flow.bias)
        with full_fp32_convs():
            return _ndhwc(F.conv3d(_ncdhw(feat.float()), self.flow.weight,
                                   self.flow.bias, padding=1)).contiguous()

    def tail(self, moving: torch.Tensor, svf: torch.Tensor, impl=None,
             with_moved: bool = True, with_fullres: bool = True) -> dict:
        """From the head's SVF to the outputs of :meth:`forward`: rescale,
        smoothing, integration (K2), the full-res field and the moved image
        (K3). ``moving`` is the forward's input ``(B, X, Y, Z, 1)``."""
        with span("vxm.tail"):
            inshape = tuple(moving.shape[1:4])
            svf, flow = graphs.segment("rescale", self._int_res_field, svf, inshape)
            with span("vxm.integrate"):
                pos_flow = integrate_svf_batch(flow, self.cfg.int_steps, self.payload_dtype,
                                               impl=impl)
            moved, flow_fullres = graphs.segment(
                "tail", self._outputs, moving if with_moved else None, pos_flow, inshape,
                with_moved, with_fullres, impl)
            return {"moved": moved, "warp": pos_flow, "flow_fullres": flow_fullres, "svf": svf}

    def _int_res_field(self, svf, inshape):
        """``(svf, flow)``: the SVF at ``1/svf_res`` (smoothed if the config says
        so) and the field to integrate, at ``1/int_res``."""
        cfg = self.cfg
        svf_shape = tuple(int(round(d / cfg.svf_res)) for d in inshape)
        if tuple(svf.shape[1:4]) != svf_shape:
            f = svf_shape[0] / svf.shape[1]
            with span("vxm.rescale"):
                svf = torch.stack([rescale_field(v, f, out_shape=svf_shape) for v in svf])

        if cfg.svf_smooth_sigma > 0:
            with span("vxm.rescale"):
                svf = smooth_field_batch(svf, cfg.svf_smooth_sigma)

        int_shape = tuple(int(round(d / cfg.int_res)) for d in inshape)
        flow = svf
        if tuple(flow.shape[1:4]) != int_shape:
            f = int_shape[0] / flow.shape[1]
            with span("vxm.rescale"):
                flow = torch.stack([rescale_field(v, f, out_shape=int_shape) for v in flow])
        return svf, flow

    def _outputs(self, moving, pos_flow, inshape, with_moved, with_fullres, impl):
        """``(moved, flow_fullres)`` from the integrated field: the full-res
        field and the moved image (K3), each None where not asked for."""
        if not (with_fullres or with_moved):
            flow_fullres = None
        elif tuple(pos_flow.shape[1:4]) != inshape:
            factors = tuple(i / c for i, c in zip(inshape, pos_flow.shape[1:4]))
            with span("vxm.fullres"):
                flow_fullres = torch.stack(
                    [rescale_field(v, factors, out_shape=inshape) for v in pos_flow])
        else:
            flow_fullres = pos_flow

        if not with_moved:
            return None, flow_fullres
        with span("vxm.warp"):
            if tuple(2 * d for d in pos_flow.shape[1:4]) == inshape:
                moved = warp_up2x_batch(moving.float(), pos_flow, impl=impl)
            else:
                moved = warp_batch(moving.float(), flow_fullres, interp="linear", impl=impl)
        return moved, flow_fullres
