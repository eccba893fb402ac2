"""Fused 3x3x3 conv + LeakyReLU + 2x max-pool: the wrapper of kernel K1
(``conv3_lrelu_pool``) and its plain version.

Counterpart of ``multimodal_registration_tpu/ops/pallas/conv_pool.py``. It
serves the U-Net's first level (enc_0) whenever the decoder never reads that
level's full-res activation (``nb_upsample_skips >= 1``), so only the pooled
tensor is written. The operands are rounded to the compute type (the input's
type: bfloat16 on the flagship path), products summed in float32, the
float32 bias added, LeakyReLU applied, the 2x2x2 max taken, and the result
rounded once to the compute type.

The kernel has no backward (neither has the JAX package's: its trainer refuses
the fused first conv). Asked for a gradient on the card, the wrapper raises;
``Unet.forward`` takes the unfused ``ConvBlock`` + ``max_pool_2x`` whenever a
gradient is needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.ops.warp import needs_grad, use_kernel

_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_HALO = 6 * 10 * 18    # input halo voxels of one block (csrc/conv_pool.cu)


def conv3_lrelu_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           neg_slope: float = 0.2) -> torch.Tensor:
    """Plain version: ``x (B, X, Y, Z, Cin)``, ``w (Cout, Cin, 3, 3, 3)``,
    ``b (Cout,)`` -> ``(B, X/2, Y/2, Z/2, Cout)`` in ``x``'s type. The conv
    runs in full float32 (TF32 off) on the card."""
    with full_fp32_convs():
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.to(x.dtype).float(),
                     b.float(), padding=1)
    y = F.leaky_relu(y, neg_slope)
    y = F.max_pool3d(y, kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv3_lrelu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     neg_slope: float = 0.2, impl=None) -> torch.Tensor:
    """``maxpool2(leaky_relu(conv3x3x3_SAME(x, w) + b))`` without writing the
    full-res activation. ``x (B, X, Y, Z, Cin)`` float32 or bfloat16 with even
    spatial dims, ``w (Cout, Cin, 3, 3, 3)`` (PyTorch layout), ``b (Cout,)``."""
    if x.ndim != 5 or w.shape[1:] != (x.shape[-1], 3, 3, 3) or b.shape != (w.shape[0],):
        raise ValueError(
            f"conv3_lrelu_pool: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)} do not fit")
    B, X, Y, Z, Cin = x.shape
    if X % 2 or Y % 2 or Z % 2:
        raise ValueError(f"conv3_lrelu_pool: spatial dims must be even, got {(X, Y, Z)}")
    if not use_kernel(x, impl):
        return conv3_lrelu_pool_plain(x, w, b, neg_slope)

    if needs_grad(x, w, b):
        raise NotImplementedError(
            "conv3_lrelu_pool (kernel K1) is inference-only, it has no backward "
            "(ROADMAP queue 2, K1 on the tensor cores and its backward): call it "
            "under torch.no_grad(), or use ConvBlock + max_pool_2x in training")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3_lrelu_pool: x must be float32 or bfloat16, got {x.dtype}")
    Cout = w.shape[0]
    smem = 4 * (27 * Cin * Cout + Cin * _HALO)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"conv3_lrelu_pool: Cin={Cin}, Cout={Cout} need {smem} B of shared "
            f"memory, more than the {_SMEM_LIMIT} B a block may use")
    if B * X * Y * Z * max(Cin, Cout) >= 2**31:
        raise ValueError("conv3_lrelu_pool: tensor too large for 32-bit indices")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3_lrelu_pool: x, w and b on different devices")
    x = x.contiguous()
    # rows k = ((dx*3 + dy)*3 + dz)*Cin + ci, operands rounded to x's type
    wk = w.to(x.dtype).float().permute(2, 3, 4, 1, 0).reshape(27 * Cin, Cout).contiguous()
    bk = b.float().contiguous()
    out = torch.empty((B, X // 2, Y // 2, Z // 2, Cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        kernels.CONV3_LRELU_POOL.launch(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
            B, X, Y, Z, Cin, Cout, float(neg_slope),
            int(x.dtype == torch.bfloat16), kernels.stream_of(x))
    return out
