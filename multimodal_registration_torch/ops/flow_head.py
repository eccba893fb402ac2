"""The flow head: the float32 3x3x3 SAME conv from the U-Net's ``C`` features
to the 3-channel SVF, forward and both gradients, on kernel K9
(``flow_head``, ``csrc/flow_head.cu``), with their plain versions.

The JAX package has no kernel for it: ``models/vxm_dense.py`` runs an XLA conv
on ``feat.astype(float32)``. Here ``feat (B, X, Y, Z, C)`` channels-last is
read as it is, bfloat16 or float32 (a bfloat16 value converts to float32
exactly), ``w (3, C, 3, 3, 3)`` and ``b (3,)`` in PyTorch's layout, and every
product and sum is float32: no TF32, no bf16 weights. The kernels sum in
another order than a library conv (see the source's note); the input gradient
comes back in the features' type, rounded once from its float32 sum, and the
weight gradient is summed in a fixed order, without atomics.

:func:`flow_head_conv` is a ``torch.autograd.Function`` whose three entries
are the kernel's; it takes CUDA tensors only (``VxmDense.flow_head`` runs the
library conv on the CPU). The plain versions below compute the same formulas
tap by tap and are what the tests hold the kernel against, in float64, within
:func:`references_and_limits`.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import full_fp32_matmuls

_TAPS = tuple(itertools.product(range(3), repeat=3))  # (dx, dy, dz), tap = (dx*3 + dy)*3 + dz
_INT_MAX = 2**31 - 1      # the largest C `int`; also the largest gridDim.x
_TY, _ZB, _WGRAD_WARPS = 4, 32, 8  # z-lines and z-block of a forward or input-gradient
                                   # block; warps of a weight-gradient block
                                   # (csrc/flow_head.cu)


# ---- plain versions -------------------------------------------------------------

def _acc_dtype(*tensors) -> torch.dtype:
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _pad(x: torch.Tensor) -> torch.Tensor:
    """``(B, X, Y, Z, K)`` zero-padded by one voxel on each side of X, Y, Z."""
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))


def flow_head_plain(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``svf[b, v, o] = b[o] + sum_{tap, c} w[o, c, tap] * feat[b, v + tap - 1, c]``:
    ``(B, X, Y, Z, 3)`` in float32 (float64 for float64 operands)."""
    B, X, Y, Z, _ = feat.shape
    acc = _acc_dtype(feat, w)
    f, wt = _pad(feat.to(acc)), w.to(acc)
    out = b.to(acc).expand(B, X, Y, Z, 3).clone()
    with full_fp32_matmuls():
        for dx, dy, dz in _TAPS:
            out += f[:, dx:dx + X, dy:dy + Y, dz:dz + Z] @ wt[:, :, dx, dy, dz].T
    return out


def flow_head_dgrad_plain(g: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The input gradient ``dfeat[b, v, c] = sum_{tap, o} w[o, c, tap] * g[b, v - tap
    + 1, o]`` of the cotangent ``g (B, X, Y, Z, 3)``, summed in float32 (float64
    for float64 operands) and rounded once to ``dtype``."""
    B, X, Y, Z, _ = g.shape
    acc = _acc_dtype(g, w)
    gp, wt = _pad(g.to(acc)), w.to(acc)
    out = torch.zeros((B, X, Y, Z, w.shape[1]), dtype=acc, device=g.device)
    with full_fp32_matmuls():
        for dx, dy, dz in _TAPS:
            src = gp[:, 2 - dx:2 - dx + X, 2 - dy:2 - dy + Y, 2 - dz:2 - dz + Z]
            out += src @ wt[:, :, dx, dy, dz]
    return out.to(dtype)


def flow_head_wgrad_plain(feat: torch.Tensor, g: torch.Tensor):
    """The weight and bias gradients ``dw[o, c, tap] = sum_{b, v} feat[b, v + tap -
    1, c] * g[b, v, o]`` ``(3, C, 3, 3, 3)`` and ``db[o] = sum_{b, v} g[b, v, o]``."""
    B, X, Y, Z, C = feat.shape
    acc = _acc_dtype(feat, g)
    f, gm = _pad(feat.to(acc)), g.to(acc).reshape(-1, 3)
    dw = torch.empty((3, C, 3, 3, 3), dtype=acc, device=feat.device)
    with full_fp32_matmuls():
        for dx, dy, dz in _TAPS:
            dw[:, :, dx, dy, dz] = gm.T @ f[:, dx:dx + X, dy:dy + Y, dz:dz + Z].reshape(-1, C)
    return dw, gm.sum(0)


def references_and_limits(feat, w, b, g, headroom: float = 4.0):
    """The four results (forward, input gradient, weight and bias gradients)
    of the plain versions in float64, each with how far a float32 sum of the
    same terms may lie from it, element by element: ``headroom * sqrt(N) *
    2**-24 * sqrt(sum of the squared terms)``, ``N`` the terms of the sum
    (``27 C + 1``, ``81``, and ``B X Y Z`` twice). A sum of ``N`` terms of
    random sign taken one after another in float32 errs by about ``sqrt(N /
    6) * 2**-24`` of that root; one term in bf16 or TF32 (``2**-9``,
    ``2**-11`` of itself) by about ``sqrt(N) / 2**15`` and ``sqrt(N) / 2**13``
    of the limit, hundreds to thousands of times more. An input gradient in
    bf16 may also lie one bf16 ulp off (its float32 sum rounded once)."""
    B, X, Y, Z, C = feat.shape
    f, wd, bd, gd = (x.detach().double() for x in (feat, w, b, g))
    want = [flow_head_plain(f, wd, bd), flow_head_dgrad_plain(gd, wd, torch.float64),
            *flow_head_wgrad_plain(f, gd)]
    sq = [flow_head_plain(f * f, wd * wd, bd * bd),
          flow_head_dgrad_plain(gd * gd, wd * wd, torch.float64),
          *flow_head_wgrad_plain(f * f, gd * gd)]
    del f, gd
    limits = [headroom * math.sqrt(n) * 2.0 ** -24 * s.sqrt()
              for n, s in zip((27 * C + 1, 81, B * X * Y * Z, B * X * Y * Z), sq)]
    if feat.dtype == torch.bfloat16:  # 2**(e - 8) for 2**(e - 1) <= |x| < 2**e
        limits[1] += torch.ldexp(torch.ones_like(want[1]), torch.frexp(want[1])[1] - 8)
    return want, limits


# ---- the kernel's entries -----------------------------------------------------------

def slots(C: int, dtype: torch.dtype):
    """``(VEC, groups)``: the channels a lane reads as one value (two bf16 in a
    32-bit word when ``C`` is even, else one) and the groups of 32 lanes that
    cover ``C``, as ``csrc/flow_head.cu`` takes them."""
    vec = 2 if dtype == torch.bfloat16 and C % 2 == 0 else 1
    return vec, -(-C // (32 * vec))


def wgrad_blocks(lines: int, groups: int, sms: int):
    """``(span, nblk)``: the weight gradient's blocks of one ``(dx, group)``
    each sum ``span`` z-lines (the last fewer), ``nblk`` of them; ``span`` is a
    multiple of the block's 8 warps, and the ``3 * groups * nblk`` blocks come
    near two a streaming multiprocessor, one wave."""
    target = max(1, 2 * sms // (3 * groups))
    span = _WGRAD_WARPS * -(-lines // (_WGRAD_WARPS * target))
    return span, max(1, -(-lines // span))


def _check(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if feat.ndim != 5 or w.shape != (3, feat.shape[-1], 3, 3, 3) or b.shape != (3,):
        raise ValueError(f"flow_head: shapes feat {tuple(feat.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} do not fit")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flow_head: feat must be float32 or bfloat16, got {feat.dtype}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"flow_head: w and b must be float32, got {w.dtype}, {b.dtype}")
    if w.device != feat.device or b.device != feat.device:
        raise ValueError("flow_head: feat, w and b on different devices")
    B, X, Y, Z, C = feat.shape
    _, groups = slots(C, feat.dtype)
    # the kernels index within a z-line and count z-lines in 32-bit `int`
    # (offsets of lines are 64-bit), and take their blocks as gridDim.x
    lines = B * X * Y
    blocks = B * X * -(-Y // _TY) * -(-Z // _ZB) * groups
    if max(lines, Z * C, blocks) > _INT_MAX:
        raise ValueError(f"flow_head: feat {tuple(feat.shape)} too large for 32-bit indices")


def _operands(*tensors):
    """Contiguous operands that start at a 16-byte boundary (the kernels copy
    the features in 16-byte pieces)."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _forward(feat, w, b):
    _check(feat, w, b)
    feat, w, b = _operands(feat, w, b)
    B, X, Y, Z, C = feat.shape
    out = torch.empty((B, X, Y, Z, 3), dtype=torch.float32, device=feat.device)
    with kernels.on_device_of(feat):
        kernels.FLOW_HEAD.launch(feat.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 B, X, Y, Z, C, int(feat.dtype == torch.bfloat16),
                                 kernels.stream_of(feat))
    return out


def _dgrad(g, w, dtype):
    g, w = _operands(g.float(), w)
    B, X, Y, Z, _ = g.shape
    C = w.shape[1]
    dfeat = torch.empty((B, X, Y, Z, C), dtype=dtype, device=g.device)
    with kernels.on_device_of(g):
        kernels.FLOW_HEAD.launch_entry(
            "flow_head_dgrad_launch", g.data_ptr(), w.data_ptr(), dfeat.data_ptr(),
            B, X, Y, Z, C, int(dtype == torch.bfloat16), kernels.stream_of(g))
    return dfeat


def _wgrad(feat, g):
    feat, g = _operands(feat, g.float())
    B, X, Y, Z, C = feat.shape
    vec, groups = slots(C, feat.dtype)
    span, nblk = wgrad_blocks(B * X * Y, groups,
                              torch.cuda.get_device_properties(feat.device).multi_processor_count)
    dev = feat.device
    part = torch.empty((nblk, 81, 32 * vec * groups), dtype=torch.float32, device=dev)
    part_bias = torch.empty((nblk, 3), dtype=torch.float32, device=dev)
    dw = torch.empty((3, C, 3, 3, 3), dtype=torch.float32, device=dev)
    db = torch.empty((3,), dtype=torch.float32, device=dev)
    is_bf16, stream = int(feat.dtype == torch.bfloat16), kernels.stream_of(feat)
    with kernels.on_device_of(feat):
        kernels.FLOW_HEAD.launch_entry(
            "flow_head_wgrad_launch", feat.data_ptr(), g.data_ptr(), part.data_ptr(),
            part_bias.data_ptr(), B, X, Y, Z, C, span, nblk, is_bf16, stream)
        kernels.FLOW_HEAD.launch_entry(
            "flow_head_wgrad_finish_launch", part.data_ptr(), part_bias.data_ptr(),
            dw.data_ptr(), db.data_ptr(), C, nblk, is_bf16, stream)
    return dw, db


class _FlowHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, w, b):
        ctx.save_for_backward(feat, w)
        return _forward(feat, w, b)

    @staticmethod
    def backward(ctx, g):
        feat, w = ctx.saved_tensors
        dfeat = dw = db = None
        if ctx.needs_input_grad[0]:
            dfeat = _dgrad(g, w, feat.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _wgrad(feat, g)
        return dfeat, dw, db


def flow_head_conv(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The head's conv ``feat (B, X, Y, Z, C)`` -> ``(B, X, Y, Z, 3)`` float32 on
    the card, differentiable in ``feat``, ``w`` and ``b``: one K9 launch
    forward; backward one launch for the input gradient and two (the blocks'
    partial sums, then their sum in block order) for the weight and bias
    gradients."""
    if feat.device.type != "cuda":
        raise ValueError(f"flow_head: the kernel takes CUDA tensors, got {feat.device}")
    return _FlowHead.apply(feat, w, b)
