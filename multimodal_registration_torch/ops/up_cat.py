"""The U-Net decoder's nearest 2x upsample and skip concatenation,
``[upsample_nearest_2x(x), skip]`` along channels, on kernel K10 (``up_cat``,
``csrc/up_cat.cu``), with its plain version.

Counterpart of the JAX package's ``_upsample_nearest_2x`` and
``jnp.concatenate`` (``multimodal_registration_tpu/models/unet.py:220``,
``:272``), which XLA runs. ``x (B, X, Y, Z, C)`` and ``skip (B, 2X, 2Y, 2Z,
Cs)`` channels-last give ``(B, 2X, 2Y, 2Z, C + Cs)``, contiguous, as
``torch.cat`` gives it: the convs that read it see the same strides either way.

:func:`upsample_cat` launches K10 on a CUDA tensor when no gradient is
recorded; under grad it runs the plain version, so that autograd keeps the
upsample's and the concatenation's backward (K10 has none). The kernel copies
bytes, so its output equals the plain version's bit for bit, in any dtype
whose rows an access of 2 bytes or more divides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops.warp import needs_grad, use_kernel
from multimodal_registration_torch.utils.profiling import span

WIDTHS = (16, 8, 4, 2)  # the kernel's accesses in bytes, widest first
_INT_MAX = 2**31 - 1    # the largest C `int`; also the largest gridDim.x


def upsample_cat_plain(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: each voxel of ``x`` repeated 2x2x2 (Keras
    ``UpSampling3D``), then ``skip``'s channels after its own."""
    up = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=2, mode="nearest")
    return torch.cat([up.permute(0, 2, 3, 4, 1), skip], dim=-1)


def access_width(x_row: int, skip_row: int, *ptrs: int) -> int | None:
    """The widest access in :data:`WIDTHS` that divides a voxel's row of x and
    of skip (in bytes) and every pointer; None if none does."""
    for w in WIDTHS:
        if x_row % w == 0 and skip_row % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return None


def _check(x: torch.Tensor, skip: torch.Tensor) -> None:
    if x.ndim != 5 or skip.ndim != 5:
        raise ValueError(f"up_cat: x {tuple(x.shape)} and skip {tuple(skip.shape)} must be "
                         "(B, X, Y, Z, C)")
    B, X, Y, Z, _ = x.shape
    if tuple(skip.shape[:4]) != (B, 2 * X, 2 * Y, 2 * Z):
        raise ValueError(f"up_cat: skip {tuple(skip.shape)} is not x {tuple(x.shape)} at "
                         "twice its size, batch for batch")
    if skip.dtype != x.dtype:
        raise TypeError(f"up_cat: x and skip must have one dtype, got {x.dtype}, {skip.dtype}")
    if skip.device != x.device:
        raise ValueError(f"up_cat: x on {x.device}, skip on {skip.device}")


def upsample_cat(x: torch.Tensor, skip: torch.Tensor, impl=None) -> torch.Tensor:
    """``[upsample_nearest_2x(x), skip]`` along channels: K10 on the card
    without grad, the plain version under grad, on the CPU or with
    ``impl="plain"``."""
    with span("unet.up_cat"):
        _check(x, skip)
        if needs_grad(x, skip) or not use_kernel(x, impl):
            return upsample_cat_plain(x, skip)
        x, skip = x.contiguous(), skip.contiguous()
        B, X, Y, Z, C = x.shape
        Cs = skip.shape[-1]
        out = torch.empty((B, 2 * X, 2 * Y, 2 * Z, C + Cs), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        size = x.element_size()
        width = access_width(C * size, Cs * size, x.data_ptr(), skip.data_ptr(), out.data_ptr())
        if width is None:
            raise TypeError(f"up_cat: no access of {WIDTHS} bytes divides rows of {C} and {Cs} "
                            f"{x.dtype} values at these pointers")
        if max(B * X * Y, 2 * Z * (C + Cs) * size // width) > _INT_MAX:
            raise ValueError(f"up_cat: x {tuple(x.shape)} too large for 32-bit indices")
        with kernels.on_device_of(x):
            kernels.UP_CAT.launch(x.data_ptr(), skip.data_ptr(), out.data_ptr(), B, X, Y, Z,
                                  C * size, Cs * size, width, kernels.stream_of(x))
        return out
