"""2x2x2 stride-2 max-pool with a hand-written adjoint: the wrapper of kernel
K4 (``max_pool_2x_bwd``) and its plain versions.

Counterpart of ``multimodal_registration_tpu/ops/pool.py::max_pool_2x``. The
forward is ``F.max_pool3d`` (the JAX package leaves it to XLA). The backward
has two tie rules, and ties are common: bfloat16 activations after a
LeakyReLU often repeat inside a window.

  * ``tie="equal"`` (the default, the JAX package's production adjoint):
    every voxel equal to its window's max receives ``g / count``, the
    quotient rounded in ``g``'s type.
  * ``tie="first"`` (what the Pallas kernels ``max_pool_2x_bwd`` and
    ``max_pool_2x_bwd_v3`` compute): one winner per window by a tournament,
    the z pair first, then the x pair, then the y pair, the lower index
    winning each tie. This is neither ``equal`` nor PyTorch's own rule
    (``F.max_pool3d`` routes to the first maximum in row-major order): when
    ``(x0, y1, z0)`` and ``(x1, y0, z0)`` tie, the tournament picks
    ``(x1, y0, z0)``. The JAX package selects it with an environment
    variable; here it is an argument.

Odd spatial dims: the pool drops the trailing plane (VALID), so the backward
crops to even dims, runs, and pads zeros back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops.warp import needs_grad, use_kernel

TIES = ("equal", "first")


def _pool_raw(x5: torch.Tensor) -> torch.Tensor:
    y = F.max_pool3d(x5.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1)


def _windows(x: torch.Tensor) -> torch.Tensor:
    """``(B, X, Y, Z, C)`` with even dims -> ``(B, X/2, 2, Y/2, 2, Z/2, 2, C)``."""
    B, X, Y, Z, C = x.shape
    return x.reshape(B, X // 2, 2, Y // 2, 2, Z // 2, 2, C)


def max_pool_2x_bwd_plain(x: torch.Tensor, g: torch.Tensor, tie: str = "equal") -> torch.Tensor:
    """Plain version of K4: ``x (B, X, Y, Z, C)`` with even dims, ``g (B,
    X/2, Y/2, Z/2, C)`` -> the gradient w.r.t. ``x``, in ``x``'s type."""
    w = _windows(x)
    gw = g[:, :, None, :, None, :, None, :]
    if tie == "equal":
        m = w.amax(dim=(2, 4, 6), keepdim=True)
        mask = w == m
        cnt = mask.to(g.dtype).sum(dim=(2, 4, 6), keepdim=True)
        grad = torch.where(mask, gw / cnt, torch.zeros((), dtype=g.dtype, device=g.device))
        return grad.reshape(x.shape).to(x.dtype)
    if tie != "first":
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    wf = w.float()
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    # forward: the z pair, then the x pair, then the y pair
    ze, zo = wf[:, :, :, :, :, :, 0], wf[:, :, :, :, :, :, 1]   # (B,Xh,2,Yh,2,Zh,C)
    mz = torch.maximum(ze, zo)
    xa, xb = mz[:, :, 0], mz[:, :, 1]                            # (B,Xh,Yh,2,Zh,C)
    mx = torch.maximum(xa, xb)
    ya, yb = mx[:, :, :, 0], mx[:, :, :, 1]                      # (B,Xh,Yh,Zh,C)
    # backward: route in reverse order; `a >= b` sends the cotangent to a
    ge = ya >= yb
    g_mx = torch.stack([torch.where(ge, g, zero), torch.where(ge, zero, g)], dim=3)
    ge = xa >= xb
    g_mz = torch.stack([torch.where(ge, g_mx, zero), torch.where(ge, zero, g_mx)], dim=2)
    ge = ze >= zo
    grad = torch.stack([torch.where(ge, g_mz, zero), torch.where(ge, zero, g_mz)], dim=6)
    return grad.reshape(x.shape).to(x.dtype)


def max_pool_2x_bwd(x: torch.Tensor, g: torch.Tensor, tie: str = "equal",
                    impl=None) -> torch.Tensor:
    """Gradient of :func:`max_pool_2x` w.r.t. ``x (B, X, Y, Z, C)`` given the
    pooled output's cotangent ``g``; kernel K4 on the card."""
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    B, X, Y, Z, C = x.shape
    even = (X - X % 2, Y - Y % 2, Z - Z % 2)
    if tuple(g.shape) != (B, even[0] // 2, even[1] // 2, even[2] // 2, C):
        raise ValueError(f"g {tuple(g.shape)} is not the pooled shape of x {tuple(x.shape)}")
    if even != (X, Y, Z):
        gx = max_pool_2x_bwd(x[:, :even[0], :even[1], :even[2]], g, tie, impl)
        return F.pad(gx, (0, 0, 0, Z - even[2], 0, Y - even[1], 0, X - even[0]))
    if not use_kernel(x, impl):
        return max_pool_2x_bwd_plain(x, g, tie)

    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype:
        raise TypeError(
            f"max_pool_2x_bwd: x and g must both be float32 or bfloat16, got {x.dtype}, {g.dtype}")
    if g.device != x.device:
        raise ValueError("max_pool_2x_bwd: x and g on different devices")
    x, g = x.contiguous(), g.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        with kernels.on_device_of(x):
            kernels.MAX_POOL_2X_BWD.launch(
                x.data_ptr(), g.data_ptr(), out.data_ptr(), B, X, Y, Z, C,
                int(tie == "first"), int(x.dtype == torch.bfloat16), kernels.stream_of(x))
    return out


class _MaxPool2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x5, tie, impl):
        ctx.save_for_backward(x5)
        ctx.tie, ctx.impl = tie, impl
        return _pool_raw(x5)

    @staticmethod
    def backward(ctx, g):
        (x5,) = ctx.saved_tensors
        return max_pool_2x_bwd(x5, g, ctx.tie, ctx.impl), None, None


def max_pool_2x(x: torch.Tensor, tie: str = "equal", impl=None) -> torch.Tensor:
    """Max-pool ``(B, X, Y, Z, C)`` or ``(X, Y, Z, C)`` channels-last; odd
    trailing planes are dropped (VALID). ``tie`` picks the backward's rule."""
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    squeeze = x.ndim == 4
    x5 = x[None] if squeeze else x
    y = _MaxPool2x.apply(x5, tie, impl) if needs_grad(x5) else _pool_raw(x5)
    return y[0] if squeeze else y
