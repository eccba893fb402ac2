"""The U-Net conv's bias and LeakyReLU, applied in place to a library conv's
output, on kernel K11 (``bias_lrelu``, ``csrc/bias_lrelu.cu``), with its plain
version.

Counterpart of the bias of ``nn.Conv`` and the ``leaky_relu`` after it in the
JAX package's U-Net (``multimodal_registration_tpu/models/unet.py``), which
XLA fuses. On the card PyTorch runs a conv with its bias as the conv without
it, then a broadcast ``add_`` of the bias cast to the compute type; the
LeakyReLU reads that sum again. ``ConvBlock.forward`` (``models/unet.py``)
instead runs the conv without its bias and hands the fresh output to
:func:`bias_lrelu_`, which gives the same bits in one pass:
``round(lrelu(round(y + round(b))))`` in float32 arithmetic, ``round`` to
the output's dtype, ``lrelu(v) = v if v > 0 else v * slope``.

``y`` is the conv's ``(B, C, D, H, W)`` output in either layout cuDNN returns,
channels-last (the main path's) or contiguous NCDHW, bfloat16 or float32;
``bias`` the conv's C float32 values. The update is in place: ``y`` is a
fresh output that nothing else reads. K11 has no backward, so under grad the
wrapper refuses; the U-Net takes autograd's composition there.
"""

from __future__ import annotations

import math

import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops.warp import needs_grad, use_kernel
from multimodal_registration_torch.utils.profiling import span

DTYPES = (torch.bfloat16, torch.float32)
WIDTHS = (16, 8, 4, 2)  # the kernel's accesses in bytes, widest first
_INT_MAX = 2**31 - 1


def layout(y: torch.Tensor) -> str | None:
    """``"channels_last"`` or ``"ncdhw"``: the dense layout of a 5-D ``y``
    (channels-last where both hold, as for one channel); None for any other."""
    if y.is_contiguous(memory_format=torch.channels_last_3d):
        return "channels_last"
    if y.is_contiguous():
        return "ncdhw"
    return None


def access_width(axis_bytes: int, ptr: int, size: int) -> int | None:
    """The widest access in :data:`WIDTHS`, of at least one value of ``size``
    bytes, that divides the bytes an access walks along (a voxel's row of
    channels, or a channel's plane) and the pointer; None if none does."""
    for w in WIDTHS:
        if w >= size and axis_bytes % w == 0 and ptr % w == 0:
            return w
    return None


def bias_lrelu_plain(y: torch.Tensor, bias: torch.Tensor, slope: float) -> torch.Tensor:
    """Plain version of K11, in place on ``y``: the kernel's roundings one
    operation at a time, in float32."""
    b = bias.to(y.dtype).float().view(1, -1, 1, 1, 1)
    v = (y.float() + b).to(y.dtype).float()
    return y.copy_(torch.where(v > 0, v, v * torch.tensor(slope, dtype=torch.float32)))


def _check(y: torch.Tensor, bias: torch.Tensor) -> str:
    if y.ndim != 5:
        raise ValueError(f"bias_lrelu_: y {tuple(y.shape)} must be (B, C, D, H, W)")
    if y.dtype not in DTYPES:
        raise TypeError(f"bias_lrelu_: y must be bfloat16 or float32, got {y.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias_lrelu_: bias must be float32, got {bias.dtype}")
    if tuple(bias.shape) != (y.shape[1],):
        raise ValueError(f"bias_lrelu_: bias {tuple(bias.shape)} is not one value a channel "
                         f"of y {tuple(y.shape)}")
    if bias.device != y.device:
        raise ValueError(f"bias_lrelu_: y on {y.device}, bias on {bias.device}")
    if needs_grad(y, bias):
        raise RuntimeError("bias_lrelu_ has no backward: call it under torch.no_grad(), or "
                           "take the conv's bias and F.leaky_relu under grad")
    lay = layout(y)
    if lay is None:
        raise ValueError(f"bias_lrelu_: y {tuple(y.shape)} with strides {y.stride()} is neither "
                         "channels-last nor contiguous NCDHW")
    return lay


def bias_lrelu_(y: torch.Tensor, bias: torch.Tensor, slope: float, impl=None) -> torch.Tensor:
    """``y = leaky_relu(y + bias per channel, slope)`` in place, rounded as the
    library's add and LeakyReLU round: K11 on the card, the plain version on
    the CPU or with ``impl="plain"``. Returns ``y``."""
    lay = _check(y, bias)
    if not use_kernel(y, impl):
        return bias_lrelu_plain(y, bias, slope)
    if y.numel() == 0:
        return y
    B, C = y.shape[:2]
    S = math.prod(y.shape[2:])
    ncdhw = lay == "ncdhw"
    size = y.element_size()
    width = access_width((S if ncdhw else C) * size, y.data_ptr(), size)
    if width is None:
        raise TypeError(f"bias_lrelu_: no access of {WIDTHS} bytes divides "
                        f"{S if ncdhw else C} {y.dtype} values at this pointer")
    if B * C > _INT_MAX:
        raise ValueError(f"bias_lrelu_: y {tuple(y.shape)} has too many channels for 32-bit "
                         "indices")
    bias = bias.contiguous()
    with span("unet.bias_lrelu"), kernels.on_device_of(y):
        kernels.BIAS_LRELU.launch(y.data_ptr(), bias.data_ptr(), B, C, S, int(ncdhw), width,
                                  float(slope), int(y.dtype == torch.bfloat16),
                                  kernels.stream_of(y))
    return y
