"""Dense-displacement spatial transformer: the wrappers of kernels K2
(``warp_trilinear``), K3 (``warp_up2x``), K5 (``warp_trilinear_bwd``), K6
(``warp_labels_soft_hard``) and K7 (its backward), with their plain versions.
K2 and K5 each have a second entry, the fused squaring step of the
scaling-and-squaring integration and its backward
(:func:`self_warp_add_batch`). K6 and K7 each have a second entry too, the
training loss's Dice of the warped one-hot, forward and backward, which never
forms the warped map or its cotangent (:func:`warp_onehot_dice_batch`).

Counterpart of ``multimodal_registration_tpu/ops/warp.py``. Semantics
(``vxm.layers.SpatialTransformer``): sample location = identity grid +
displacement, clamped to ``[0, dim-1]``; ``linear`` mixes the 8 corners
(``i1 = min(i0+1, dim-1)``) in float32 and rounds once to the volume's type;
``nearest`` rounds half to even. The JAX package's packed, chunked and
halo-``cond`` machinery is a TPU layout workaround and has no counterpart.

Every public function takes ``impl``: ``None`` launches the CUDA kernel for a
tensor on the card and runs the plain PyTorch version for a tensor on the
CPU; ``"plain"`` runs the plain version anywhere (tests and ``chip_smoke.py``
compare the two). A CUDA tensor never falls back to the plain version.

Gradients. K2 is differentiable: its backward is kernel K5 (the scatter-add
into the volume, summed in float32 and rounded once, and the gradient w.r.t.
the coordinates through the trilinear weights). K6's backward w.r.t. the flow
is K7; the fused Dice loss's backward is K7's Dice entry. K3 has no backward yet and raises when a gradient is asked of it. The
plain versions are differentiable by autograd. The clip's derivative follows
the JAX package's rule in kernels and plain versions alike: ``jnp.clip`` is
``min(max(c, 0), dim-1)`` and each of ``max`` and ``min`` splits its
derivative evenly between equal arguments, so a coordinate that sits exactly
on a bound (a border voxel with zero displacement) passes one half, not the
one that ``torch.clamp`` passes. ``torch.maximum``/``torch.minimum`` have the
same rule, so the plain clip is written with them. On the far bound both
corners are the same voxel (``i1 == i0``), so the slope there is zero, as in
the JAX package's production ("packed") and "gather8" samplers; its
"blockgather" sampler, the default on a CPU, anchors the last cell at
``dim-2`` and passes half of the left slope instead (the values agree, the
gradients at that one coordinate do not), so the parity tests run the JAX
side with ``MMREG_WARP_MODE=packed``.

K5 sums the volume's gradient in a float32 scratch buffer that this module
owns, one per device, stream and size, and that is all zeros between two
backward passes: the kernel that rounds the sums into the gradient zeroes
them behind it, so a backward pass needs no memset. Sums through atomics
differ from run to run in the last bits.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from multimodal_registration_torch import kernels
from multimodal_registration_torch.losses import dice_loss, dice_loss_zeropad
from multimodal_registration_torch.ops.grid import identity_grid
from multimodal_registration_torch.ops.resize import rescale_field


def use_kernel(t: torch.Tensor, impl) -> bool:
    """Whether a wrapper given ``t`` launches its kernel (``True``) or runs
    its plain version (``False``)."""
    if impl == "plain":
        return False
    if impl is not None:
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check_payload(vol: torch.Tensor, name: str) -> None:
    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: payload must be float32 or bfloat16, got {vol.dtype}")


def _sample_plain(vol: torch.Tensor, c: torch.Tensor, interp: str) -> torch.Tensor:
    """Plain version of K2 on clipped coordinates: ``vol (B, X, Y, Z, C)``,
    ``c (B, N, 3)`` float32 in ``[0, dim-1]`` -> ``(B, N, C)``."""
    B, X, Y, Z, C = vol.shape
    flat = vol.reshape(B, X * Y * Z, C)
    acc_dtype = torch.promote_types(c.dtype, torch.float32)  # float64 for gradcheck

    def gather(ix, iy, iz):
        lin = (ix * Y + iy) * Z + iz
        return torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))

    if interp == "nearest":
        i = torch.round(c).long()  # half to even, like jnp.round
        return gather(i[..., 0], i[..., 1], i[..., 2])
    if interp != "linear":
        raise ValueError(f"interp must be 'linear' or 'nearest', got {interp!r}")
    c0 = torch.floor(c)
    w1 = c - c0
    i0 = c0.long()
    i1 = torch.minimum(i0 + 1, torch.tensor([X - 1, Y - 1, Z - 1], device=c.device))
    out = None
    for dx in (0, 1):
        wx = w1[..., 0] if dx else 1.0 - w1[..., 0]
        ix = i1[..., 0] if dx else i0[..., 0]
        for dy in (0, 1):
            wy = w1[..., 1] if dy else 1.0 - w1[..., 1]
            iy = i1[..., 1] if dy else i0[..., 1]
            for dz in (0, 1):
                wz = w1[..., 2] if dz else 1.0 - w1[..., 2]
                iz = i1[..., 2] if dz else i0[..., 2]
                term = gather(ix, iy, iz).to(acc_dtype) * (wx * wy * wz)[..., None]
                out = term if out is None else out + term
    return out.to(vol.dtype)


def _clip(c: torch.Tensor, X: int, Y: int, Z: int) -> torch.Tensor:
    """``min(max(c, 0), dim-1)``; at equality with a bound the derivative is
    one half (see the module's note), which ``torch.clamp`` would not give."""
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=c.dtype, device=c.device)
    return torch.minimum(torch.maximum(c, torch.zeros((), dtype=c.dtype, device=c.device)), hi)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an operation on ``tensors`` now."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


# (device, stream, numel) -> [float32 zeros, in use]: K5's sums
_SCRATCH: dict = {}
_SCRATCH_MAX = 8  # a device's: the shapes of a run are few; drop the oldest, do not hoard


def _scratch(like: torch.Tensor, numel: int) -> list:
    """The zeroed float32 scratch buffer of ``numel`` values for K5 on
    ``like``'s device and current stream, marked in use. The caller clears
    the mark once the kernel that zeroes the buffer again is enqueued; a
    buffer found marked was left dirty by a failed backward and is zeroed.
    Each device holds at most ``_SCRATCH_MAX`` buffers, its oldest going
    first."""
    key = (like.device, kernels.stream_of(like), numel)
    entry = _SCRATCH.get(key)
    if entry is None:
        mine = [k for k in _SCRATCH if k[0] == like.device]
        if len(mine) >= _SCRATCH_MAX:
            del _SCRATCH[mine[0]]
        entry = _SCRATCH[key] = [torch.zeros(numel, dtype=torch.float32, device=like.device),
                                 False]
    elif entry[1]:
        entry[0].zero_()
    entry[1] = True
    return entry


def scratch_buffers() -> list:
    """K5's cached scratch buffers (all zeros between backward passes)."""
    return [entry[0] for entry in _SCRATCH.values()]


def clear_scratch() -> None:
    """Drop K5's cached scratch buffers (they are made again when needed)."""
    _SCRATCH.clear()


def _launch_warp(vol5, coords, Yo, Zo, coords_are_flow, nearest):
    """Launch K2 on contiguous CUDA tensors: ``vol5 (B, X, Y, Z, C)``,
    ``coords (B, N, 3)`` float32 -> ``(B, N, C)``."""
    B, X, Y, Z, C = vol5.shape
    N = coords.shape[1]
    out = torch.empty((B, N, C), dtype=vol5.dtype, device=vol5.device)
    with kernels.on_device_of(vol5):
        kernels.WARP_TRILINEAR.launch(
            vol5.data_ptr(), coords.data_ptr(), out.data_ptr(), B, X, Y, Z, C,
            N, Yo, Zo, int(coords_are_flow), int(nearest),
            int(vol5.dtype == torch.bfloat16), kernels.stream_of(vol5))
    return out


class _WarpTrilinear(torch.autograd.Function):
    """K2 forward, K5 backward."""

    @staticmethod
    def forward(ctx, vol5, coords, Yo, Zo, coords_are_flow, nearest):
        out = _launch_warp(vol5, coords, Yo, Zo, coords_are_flow, nearest)
        ctx.save_for_backward(vol5, coords)
        ctx.meta = (Yo, Zo, coords_are_flow, nearest)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        vol5, coords = ctx.saved_tensors
        Yo, Zo, coords_are_flow, nearest = ctx.meta
        B, X, Y, Z, C = vol5.shape
        N = coords.shape[1]
        want_vol = ctx.needs_input_grad[0]
        want_coords = ctx.needs_input_grad[1] and not nearest
        if not (want_vol or want_coords):
            return None, None, None, None, None, None
        gvol = torch.empty_like(vol5) if want_vol else None
        gcoords = torch.empty_like(coords) if want_coords else None
        gout = gout.contiguous()  # autograd hands it over in the output's type
        is_bf16 = int(vol5.dtype == torch.bfloat16)
        with kernels.on_device_of(vol5):
            stream = kernels.stream_of(vol5)
            scratch = _scratch(vol5, vol5.numel()) if want_vol else None
            kernels.WARP_TRILINEAR_BWD.launch(
                vol5.data_ptr(), coords.data_ptr(), gout.data_ptr(),
                scratch[0].data_ptr() if want_vol else None,
                gcoords.data_ptr() if want_coords else None,
                B, X, Y, Z, C, N, Yo, Zo, int(coords_are_flow), int(nearest), is_bf16, stream)
            if want_vol:  # the float32 sums, rounded once, and zeroed behind
                kernels.WARP_TRILINEAR_BWD.launch_entry(
                    "warp_bwd_finish_launch", gvol.data_ptr(), scratch[0].data_ptr(),
                    vol5.numel(), is_bf16, stream, count=False)
                scratch[1] = False
        return gvol, gcoords, None, None, None, None


def _warp_trilinear(vol5, coords, out_grid, coords_are_flow, interp, impl):
    """K2 dispatch: ``vol5 (B, X, Y, Z, C)``, ``coords (B, N, 3)`` (absolute
    or displacements on the ``out_grid`` of N voxels) -> ``(B, N, C)``."""
    B, X, Y, Z, C = vol5.shape
    if interp not in ("linear", "nearest"):
        raise ValueError(f"interp must be 'linear' or 'nearest', got {interp!r}")
    if coords.shape[0] != B or coords.shape[-1] != 3:
        raise ValueError(f"coords {tuple(coords.shape)} do not match volume {tuple(vol5.shape)}")
    if not use_kernel(vol5, impl):
        c = coords.float()
        if coords_are_flow:
            c = identity_grid(out_grid, device=c.device).reshape(1, -1, 3) + c
        return _sample_plain(vol5, _clip(c, X, Y, Z), interp)

    _check_payload(vol5, "warp_trilinear")
    vol5 = vol5.contiguous()
    coords = coords.float().contiguous()
    if coords.device != vol5.device:
        raise ValueError("warp_trilinear: volume and coordinates on different devices")
    N = coords.shape[1]
    if max(B * X * Y * Z * C, B * N * C) >= 2**31 or N >= 2**31:
        raise ValueError("warp_trilinear: tensor too large for 32-bit voxel indices")
    Yo, Zo = (out_grid[1], out_grid[2]) if coords_are_flow else (1, 1)
    args = (vol5, coords, Yo, Zo, bool(coords_are_flow), interp == "nearest")
    # the serving path asks for no gradient and skips autograd's bookkeeping
    return _WarpTrilinear.apply(*args) if needs_grad(vol5, coords) else _launch_warp(*args)


def _self_warp_add_plain(phi: torch.Tensor, payload_dtype) -> torch.Tensor:
    """Plain version of the fused squaring step (and, through autograd, of
    its backward): cast, warp, cast back, add."""
    if payload_dtype is not None:
        inc = warp_batch(phi.to(payload_dtype), phi, interp="linear", impl="plain").float()
    else:
        inc = warp_batch(phi, phi, interp="linear", impl="plain")
    return phi + inc


def _launch_self_warp_add(phi, is_bf16):
    """Launch K2's fused step on a contiguous float32 CUDA field."""
    B, X, Y, Z, _ = phi.shape
    out = torch.empty_like(phi)
    with kernels.on_device_of(phi):
        kernels.WARP_TRILINEAR.launch_entry(
            "self_warp_add_launch", phi.data_ptr(), out.data_ptr(), B, X, Y, Z, int(is_bf16),
            kernels.stream_of(phi))
    return out


def _launch_self_warp_add_bwd(phi, g, is_bf16):
    """Launch K5's fused step: kernel A (``g + gcoords`` into the result, the
    volume term's float32 sums into the scratch buffer), then kernel B (adds
    the sums, rounded once to the payload's type, and zeroes them)."""
    B, X, Y, Z, _ = phi.shape
    out = torch.empty_like(phi)
    with kernels.on_device_of(phi):
        stream = kernels.stream_of(phi)
        scratch = _scratch(phi, phi.numel())
        kernels.WARP_TRILINEAR_BWD.launch_entry(
            "self_warp_add_bwd_launch", phi.data_ptr(), g.data_ptr(), out.data_ptr(),
            scratch[0].data_ptr(), B, X, Y, Z, int(is_bf16), stream)
        kernels.WARP_TRILINEAR_BWD.launch_entry(
            "self_warp_add_finish_launch", out.data_ptr(), scratch[0].data_ptr(), phi.numel(),
            int(is_bf16), stream, count=False)
        scratch[1] = False
    return out


class _SelfWarpAdd(torch.autograd.Function):
    """The fused squaring step: K2's ``self_warp_add`` forward, K5's backward."""

    @staticmethod
    def forward(ctx, phi, is_bf16):
        out = _launch_self_warp_add(phi, is_bf16)
        ctx.save_for_backward(phi)
        ctx.is_bf16 = is_bf16
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (phi,) = ctx.saved_tensors
        return _launch_self_warp_add_bwd(phi, g.float().contiguous(), ctx.is_bf16), None


def self_warp_add_grad_float64(phi: torch.Tensor, g: torch.Tensor,
                               payload_dtype=None) -> torch.Tensor:
    """The fused squaring step's backward as its formula states it, every sum
    in float64: ``g + f32(round_T(gvol)) + gcoords`` for the cotangent ``g``,
    with ``gvol`` the scatter-add of ``w_k * T(g)`` into the corners and
    ``gcoords`` the gradient through the trilinear weights of the ``T``-rounded
    field. Coordinates, corners and the clip are those of float32, as in the
    kernel and the plain version. It is the yardstick that says which of the
    two is off where they differ: autograd of the plain version rounds every
    contribution to ``T`` and scatters in ``T``, the kernel sums in float32
    and rounds once. Runs anywhere; used by tests and ``chip_smoke.py`` only."""
    B, X, Y, Z, _ = phi.shape
    T = payload_dtype or torch.float32
    leaf = phi.detach().requires_grad_()
    vol = phi.detach().to(T).double().requires_grad_()
    grid = identity_grid((X, Y, Z), device=phi.device).reshape(1, -1, 3)
    c = _clip(grid + leaf.reshape(B, -1, 3), X, Y, Z).double()
    out = _sample_plain(vol, c, "linear")
    gvol, gcoords = torch.autograd.grad(out, [vol, leaf], g.to(T).double().reshape(B, -1, 3))
    return g + gvol.to(T).float() + gcoords


def self_warp_add_batch(phi: torch.Tensor, payload_dtype=None, impl=None) -> torch.Tensor:
    """One squaring step of the scaling-and-squaring integration on a batch
    of float32 displacement fields ``phi (B, X, Y, Z, 3)``:
    ``phi + warp(phi.to(T), phi).float()`` with ``T = payload_dtype`` (bfloat16
    or float32; ``None`` is float32), equal bit for bit to those operations.
    On the card it is one launch of K2's fused entry that reads the field once,
    and its backward is two launches of K5's."""
    if phi.ndim != 5 or phi.shape[-1] != 3:
        raise ValueError(f"phi {tuple(phi.shape)} must be (B, X, Y, Z, 3)")
    if phi.dtype != torch.float32:
        raise TypeError(f"self_warp_add: the field must be float32, got {phi.dtype}")
    if payload_dtype == torch.float32:
        payload_dtype = None
    if not use_kernel(phi, impl):
        return _self_warp_add_plain(phi, payload_dtype)
    if payload_dtype not in (None, torch.bfloat16):
        raise TypeError(f"self_warp_add: payload must be float32 or bfloat16, got {payload_dtype}")
    if phi.numel() >= 2**31:
        raise ValueError("self_warp_add: tensor too large for 32-bit voxel indices")
    phi = phi.contiguous()
    is_bf16 = payload_dtype is torch.bfloat16
    # the serving path asks for no gradient and skips autograd's bookkeeping
    return _SelfWarpAdd.apply(phi, is_bf16) if needs_grad(phi) else _launch_self_warp_add(phi, is_bf16)


def sample(vol: torch.Tensor, coords: torch.Tensor, interp: str = "linear",
           impl=None) -> torch.Tensor:
    """Sample ``vol (X, Y, Z[, C])`` at absolute voxel ``coords (..., 3)``;
    returns ``(..., C)`` (no channel axis if ``vol`` had none)."""
    squeeze = vol.ndim == 3
    v5 = (vol[..., None] if squeeze else vol)[None]
    lead = coords.shape[:-1]
    out = _warp_trilinear(v5, coords.reshape(1, -1, 3), None, False, interp, impl)
    out = out.reshape(*lead, v5.shape[-1])
    return out[..., 0] if squeeze else out


def warp_batch(vol: torch.Tensor, flow: torch.Tensor, interp: str = "linear",
               impl=None) -> torch.Tensor:
    """Warp ``vol (B, X, Y, Z[, C])`` by ``flow (B, X', Y', Z', 3)``:
    ``out(x) = vol(x + flow(x))`` on the flow's grid."""
    squeeze = vol.ndim == 4
    v5 = vol[..., None] if squeeze else vol
    grid = tuple(flow.shape[1:4])
    out = _warp_trilinear(v5, flow.reshape(flow.shape[0], -1, 3), grid, True,
                          interp, impl)
    out = out.reshape(flow.shape[0], *grid, v5.shape[-1])
    return out[..., 0] if squeeze else out


def warp(vol: torch.Tensor, flow: torch.Tensor, interp: str = "linear",
         impl=None) -> torch.Tensor:
    """Unbatched :func:`warp_batch`: ``vol (X, Y, Z[, C])``, ``flow (X, Y, Z, 3)``."""
    return warp_batch(vol[None], flow[None], interp=interp, impl=impl)[0]


def warp_up2x_batch(vol: torch.Tensor, flow_half: torch.Tensor, impl=None) -> torch.Tensor:
    """Warp full-res ``vol (B, X, Y, Z[, C])`` by the corner-aligned 2x
    upsample (vectors x2) of the half-res field ``flow_half (B, X/2, Y/2,
    Z/2, 3)``; linear only. The kernel never writes the full-res field."""
    squeeze = vol.ndim == 4
    v5 = vol[..., None] if squeeze else vol
    B, X, Y, Z, C = v5.shape
    if X % 2 or Y % 2 or Z % 2 or tuple(flow_half.shape) != (B, X // 2, Y // 2, Z // 2, 3):
        raise ValueError(
            f"flow_half {tuple(flow_half.shape)} is not the half grid of {tuple(v5.shape)}")
    if not use_kernel(v5, impl):
        full = torch.stack([rescale_field(f, 2, out_shape=(X, Y, Z)) for f in flow_half.float()])
        out = warp_batch(v5, full, interp="linear", impl="plain")
    else:
        if needs_grad(v5, flow_half):
            raise NotImplementedError(
                "warp_up2x (kernel K3) has no backward: call it under torch.no_grad(), "
                "or use warp_batch on the rescaled field where a gradient is needed")
        _check_payload(v5, "warp_up2x")
        v5 = v5.contiguous()
        fh = flow_half.float().contiguous()
        if fh.device != v5.device:
            raise ValueError("warp_up2x: volume and field on different devices")
        if B * X * Y * Z * C >= 2**31:
            raise ValueError("warp_up2x: tensor too large for 32-bit voxel indices")
        out = torch.empty_like(v5)
        with kernels.on_device_of(v5):
            kernels.WARP_UP2X.launch(
                v5.data_ptr(), fh.data_ptr(), out.data_ptr(), B, X, Y, Z, C,
                int(v5.dtype == torch.bfloat16), kernels.stream_of(v5))
    return out[..., 0] if squeeze else out


def _check_labels(labels: torch.Tensor, flow: torch.Tensor, num_classes: int) -> None:
    if labels.ndim != 4 or tuple(flow.shape) != (*labels.shape, 3):
        raise ValueError(
            f"labels {tuple(labels.shape)} must be (B, X, Y, Z) and flow "
            f"{tuple(flow.shape)} (B, X, Y, Z, 3)")
    if labels.dtype not in (torch.uint8, torch.int32, torch.int64):
        raise TypeError(f"labels must be uint8, int32 or int64, got {labels.dtype}")
    if num_classes < 1:
        raise ValueError(f"num_classes must be positive, got {num_classes}")


def _label_corners_plain(labels, flow):
    """The 8 corners of each voxel's sample in (dx, dy, dz) order, as K6
    takes them: ``(r, w1, labs, ws)``, the unclipped coordinates ``(B, N,
    3)``, the fractions of the clipped ones ``(B, N, 3)``, the corners'
    labels ``(B, N, 8)`` int64 and trilinear weights ``(wx*wy)*wz`` ``(B, N,
    8)`` float32, differentiable w.r.t. ``flow``."""
    B, X, Y, Z = labels.shape
    N = X * Y * Z
    grid = identity_grid((X, Y, Z), device=flow.device).reshape(1, N, 3)
    r = grid + flow.float().reshape(B, N, 3)
    c = _clip(r, X, Y, Z)
    flat = labels.reshape(B, N).long()
    c0 = torch.floor(c)
    w1 = c - c0
    i0 = c0.long()
    i1 = torch.minimum(i0 + 1, torch.tensor([X - 1, Y - 1, Z - 1], device=c.device))
    labs, ws = [], []
    for dx in (0, 1):
        wx = w1[..., 0] if dx else 1.0 - w1[..., 0]
        ix = i1[..., 0] if dx else i0[..., 0]
        for dy in (0, 1):
            wy = w1[..., 1] if dy else 1.0 - w1[..., 1]
            iy = i1[..., 1] if dy else i0[..., 1]
            for dz in (0, 1):
                wz = w1[..., 2] if dz else 1.0 - w1[..., 2]
                iz = i1[..., 2] if dz else i0[..., 2]
                labs.append(torch.gather(flat, 1, (ix * Y + iy) * Z + iz))
                ws.append(wx * wy * wz)
    return r, w1, torch.stack(labs, -1), torch.stack(ws, -1)


def _warp_labels_plain(labels, flow, num_classes):
    """Plain version of K6, differentiable w.r.t. ``flow`` by autograd (which
    is the plain version of K7). Labels must lie in ``[0, num_classes)``.
    Each voxel's sums are taken corner by corner, in K6's order, so the soft
    map equals K6's bit for bit on any device."""
    B, X, Y, Z = labels.shape
    N = X * Y * Z
    r, _, labs, ws = _label_corners_plain(labels, flow)
    soft = torch.zeros((B, N, num_classes), dtype=torch.float32, device=flow.device)
    for i in range(8):
        soft = soft.scatter_add(2, labs[..., i:i + 1], ws[..., i:i + 1])
    rr = torch.round(_clip(r.detach(), X, Y, Z)).long()  # half to even, like jnp.round
    hard = torch.gather(labels.reshape(B, N).long(), 1, (rr[..., 0] * Y + rr[..., 1]) * Z + rr[..., 2])
    return soft.reshape(B, X, Y, Z, num_classes), hard.reshape(B, X, Y, Z).to(torch.int32)


class _WarpLabels(torch.autograd.Function):
    """K6 forward, K7 backward, on contiguous CUDA tensors."""

    @staticmethod
    def forward(ctx, labels, flow, num_classes):
        B, X, Y, Z = labels.shape
        soft = torch.empty((B, X, Y, Z, num_classes), dtype=torch.float32, device=flow.device)
        hard = torch.empty((B, X, Y, Z), dtype=torch.int32, device=flow.device)
        with kernels.on_device_of(flow):
            kernels.WARP_LABELS.launch(
                labels.data_ptr(), flow.data_ptr(), soft.data_ptr(), hard.data_ptr(),
                B, X, Y, Z, num_classes, int(labels.dtype == torch.uint8),
                kernels.stream_of(flow))
        ctx.save_for_backward(labels, flow)
        ctx.num_classes = num_classes
        ctx.mark_non_differentiable(hard)
        # no zeros for the cotangent of ``hard`` (a fill of B*X*Y*Z int32 at
        # every backward): it is never used
        ctx.set_materialize_grads(False)
        return soft, hard

    @staticmethod
    def backward(ctx, gsoft, _ghard):
        if gsoft is None:
            return None, None, None
        labels, flow = ctx.saved_tensors
        B, X, Y, Z = labels.shape
        gflow = torch.empty_like(flow)
        gsoft = gsoft.float().contiguous()
        with kernels.on_device_of(flow):
            kernels.WARP_LABELS_BWD.launch(
                gsoft.data_ptr(), labels.data_ptr(), flow.data_ptr(), gflow.data_ptr(),
                B, X, Y, Z, ctx.num_classes, int(labels.dtype == torch.uint8),
                kernels.stream_of(flow))
        return None, gflow, None


def warp_labels_soft_hard_batch(labels: torch.Tensor, flow: torch.Tensor,
                                num_classes: int, impl=None):
    """Warp integer label maps ``(B, X, Y, Z)`` with values in ``[0,
    num_classes)`` by ``flow (B, X, Y, Z, 3)``. Returns ``(soft, hard)``:
    ``soft (B, X, Y, Z, L)`` float32, the trilinear warp of the one-hot map
    (the corner-weighted sum of the one-hots of the 8 corner labels; the
    one-hot itself is never formed), differentiable w.r.t. ``flow``; and
    ``hard (B, X, Y, Z)`` int32, the nearest-neighbour warp (half to even)."""
    _check_labels(labels, flow, num_classes)
    if not use_kernel(flow, impl):
        return _warp_labels_plain(labels, flow, num_classes)
    if labels.device != flow.device:
        raise ValueError("warp_labels_soft_hard: labels and flow on different devices")
    B, X, Y, Z = labels.shape
    if X * Y * Z >= 2**31:
        raise ValueError("warp_labels_soft_hard: volume too large for 32-bit voxel indices")
    if labels.dtype == torch.int64:
        labels = labels.to(torch.int32)
    return _WarpLabels.apply(labels.contiguous(), flow.float().contiguous(), int(num_classes))


def warp_labels_soft_hard(labels: torch.Tensor, flow: torch.Tensor, num_classes: int,
                          impl=None):
    """Unbatched :func:`warp_labels_soft_hard_batch`: ``labels (X, Y, Z)``,
    ``flow (X, Y, Z, 3)`` -> ``(soft (X, Y, Z, L), hard (X, Y, Z))``."""
    soft, hard = warp_labels_soft_hard_batch(labels[None], flow[None], num_classes, impl)
    return soft[0], hard[0]


def warp_onehot_batch(labels: torch.Tensor, flow: torch.Tensor, num_classes: int,
                      impl=None) -> torch.Tensor:
    """Trilinear warp of ``one_hot(labels)``: the soft output of
    :func:`warp_labels_soft_hard_batch`."""
    return warp_labels_soft_hard_batch(labels, flow, num_classes, impl)[0]


def warp_onehot(labels: torch.Tensor, flow: torch.Tensor, num_classes: int,
                impl=None) -> torch.Tensor:
    """Unbatched :func:`warp_onehot_batch`."""
    return warp_labels_soft_hard(labels, flow, num_classes, impl)[0]


# ---- the training loss's Dice of the warped one-hot, fused ----------------------
#
# With t = the target map and p = warp_onehot(labels, flow), per (b, l):
# I = sum_v keep t p, P = sum_v keep p, T = sum_v keep t, S = T + P, and the
# loss d = -mean_{b,l} safe_div(2 I, S) (``losses.dice_loss``; with zeropad
# ``dice_loss_zeropad``: keep = 0 where t[..., 0] >= 1 or p[..., 0] >= 1, and
# label 0 left out of the mean). Its cotangent is affine in t:
# dd/dp[b, v, l] = keep (alpha[b, l] t[b, v, l] + beta[b, l]) with
# alpha = -2 / (n S), beta = 2 I / (n S^2), n the count of (b, l) in the mean,
# both 0 where S = 0 (safe_div's zero gradient) and for label 0 with zeropad.
# So the forward needs the 3 B L sums and the backward 2 B L coefficients and
# t at each voxel's corner labels: the (B, X, Y, Z, L) prediction and its
# cotangent are never formed. K6's second entry sums, K7's second entry forms
# the cotangent in registers and contracts it with the weights' derivatives.

_DICE_BLOCKS = 512  # blocks per batch element, at most (csrc/warp_labels.cu)
_DICE_SMEM_MAX = 100 * 1024


def _dice_smem(tv: int, num_classes: int) -> int:
    """Bytes of shared memory a block of the Dice forward takes
    (``csrc/warp_labels.cu::dice_fwd_smem``)."""
    return 4 * max(3 * (tv * num_classes + 8) + 2 * (3 * tv + 4), 256 * 24)


def _dice_plan(n_voxels: int, num_classes: int):
    """The Dice forward's tile voxels and blocks per batch element, both
    functions of the volume and the label count alone (so a batch element's
    sums do not depend on the batch): ``(TV, G)``."""
    tv = 128
    while tv > 32 and _dice_smem(tv, num_classes) > _DICE_SMEM_MAX:
        tv //= 2
    return tv, min(-(-n_voxels // tv), _DICE_BLOCKS)


def _check_dice(labels, flow, t, num_classes):
    _check_labels(labels, flow, num_classes)
    if tuple(t.shape) != (*labels.shape, num_classes):
        raise ValueError(
            f"the target map {tuple(t.shape)} must be (B, X, Y, Z, L) = "
            f"{(*labels.shape, num_classes)}")


def _dice_keep_plain(tf, labs, ws, zeropad):
    """``keep (B, N)`` float32: 1, or with ``zeropad`` 0 where ``t[..., 0] >=
    1`` or ``p[..., 0] >= 1``, ``p[..., 0]`` summed corner by corner as K6
    sums it (so the test flips on the same voxels)."""
    if not zeropad:
        return torch.ones(tf.shape[:2], dtype=torch.float32, device=tf.device)
    p0 = torch.zeros(tf.shape[:2], dtype=torch.float32, device=tf.device)
    for i in range(8):
        p0 = p0 + torch.where(labs[..., i] == 0, ws[..., i], 0.0)
    return (~((tf[..., 0] >= 1.0) | (p0 >= 1.0))).float()


def _dice_sums_plain(labels, flow, t, num_classes, zeropad):
    """Plain version of K6's Dice entry: ``(B, L, 3)`` float32, the sums
    ``(I, P, T)`` of each (b, l), from the corner weights (``scatter_add``
    into the corners' labels) and summed in float64."""
    B = labels.shape[0]
    L = num_classes
    with torch.no_grad():
        _, _, labs, ws = _label_corners_plain(labels, flow)
        tf = t.reshape(B, -1, L).float()
        keep = _dice_keep_plain(tf, labs, ws, zeropad)
        valid = (labs >= 0) & (labs < L)
        lc = torch.where(valid, labs, 0)
        kw = (torch.where(valid, ws, 0.0) * keep[..., None]).double()
        zeros = torch.zeros((B, L), dtype=torch.float64, device=flow.device)
        P = zeros.scatter_add(1, lc.reshape(B, -1), kw.reshape(B, -1))
        I = zeros.scatter_add(1, lc.reshape(B, -1),
                              (kw * tf.gather(2, lc).double()).reshape(B, -1))
        T = (tf.double() * keep.double()[..., None]).sum(1)
        return torch.stack([I, P, T], -1).float()


def _clip_grad_plain(r, hi):
    """Derivative of ``min(max(r, 0), hi)``: one half at equality with a bound."""
    lo_d = torch.where(r > 0, 1.0, torch.where(r == 0, 0.5, 0.0))
    m = torch.clamp(r, min=0.0)
    return lo_d * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))


def _dice_flow_grad_plain(labels, flow, t, coef, num_classes, zeropad):
    """Plain version of K7's Dice entry: the flow gradient ``(B, X, Y, Z,
    3)`` of sum_{v,l} g p with ``g = keep (alpha t + beta)`` taken at each
    corner's label (``gather``), through the weights' derivatives and the
    clip's."""
    B, X, Y, Z = labels.shape
    L = num_classes
    with torch.no_grad():
        r, w1, labs, ws = _label_corners_plain(labels, flow)
        tf = t.reshape(B, -1, L).float()
        keep = _dice_keep_plain(tf, labs, ws, zeropad)
        valid = (labs >= 0) & (labs < L)
        lc = torch.where(valid, labs, 0)
        flat = lc.reshape(B, -1)
        alpha = coef[..., 0].float().gather(1, flat).reshape(lc.shape)
        beta = coef[..., 1].float().gather(1, flat).reshape(lc.shape)
        gc = torch.where(valid, alpha * tf.gather(2, lc) + beta, 0.0) * keep[..., None]
        w = [(1.0 - w1[..., a], w1[..., a]) for a in range(3)]
        gx = gy = gz = 0.0
        for i in range(8):
            dx, dy, dz = i >> 2, (i >> 1) & 1, i & 1
            gx = gx + gc[..., i] * (1.0 if dx else -1.0) * w[1][dy] * w[2][dz]
            gy = gy + gc[..., i] * (1.0 if dy else -1.0) * w[0][dx] * w[2][dz]
            gz = gz + gc[..., i] * (1.0 if dz else -1.0) * w[0][dx] * w[1][dy]
        hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=flow.device)
        g = torch.stack([gx, gy, gz], -1) * _clip_grad_plain(r, hi)
        return g.reshape(B, X, Y, Z, 3)


def _kernel_labels(labels, flow, t, num_classes, what):
    """Checks of a Dice entry's CUDA path; ``labels`` as the kernel takes them."""
    if labels.device != flow.device or t.device != flow.device:
        raise ValueError(f"{what}: labels, flow and target map on different devices")
    if not 1 <= num_classes <= 256:
        raise ValueError(f"{what}: the kernel takes 1 to 256 labels, got {num_classes}")
    if math.prod(labels.shape[1:]) >= 2**31:
        raise ValueError(f"{what}: volume too large for 32-bit voxel indices")
    return labels.to(torch.int32) if labels.dtype == torch.int64 else labels


def warp_labels_dice_sums(labels: torch.Tensor, flow: torch.Tensor, t: torch.Tensor,
                          num_classes: int, zeropad: bool = False, impl=None) -> torch.Tensor:
    """The Dice sums of ``t`` against the warp of ``one_hot(labels)`` by
    ``flow``, without forming the warp: ``(B, L, 3)`` float32 holding, per
    batch element and label, ``I = sum keep t p``, ``P = sum keep p`` and ``T =
    sum keep t`` (see the section's note). K6's second entry on the card."""
    _check_dice(labels, flow, t, num_classes)
    if not use_kernel(flow, impl):
        return _dice_sums_plain(labels, flow, t, num_classes, zeropad)
    labels = _kernel_labels(labels, flow, t, num_classes, "warp_labels_dice_sums").contiguous()
    flow = flow.detach().float().contiguous()
    t = t.detach().float().contiguous()
    B, X, Y, Z = labels.shape
    tv, blocks = _dice_plan(X * Y * Z, num_classes)
    partial = torch.empty(B * blocks * num_classes * 3, dtype=torch.float64, device=flow.device)
    sums = torch.empty((B, num_classes, 3), dtype=torch.float32, device=flow.device)
    with kernels.on_device_of(flow):
        kernels.WARP_LABELS.launch_entry(
            "warp_labels_dice_fwd_launch", labels.data_ptr(), flow.data_ptr(), t.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), B, X, Y, Z, num_classes, tv, blocks,
            int(zeropad), int(labels.dtype == torch.uint8), kernels.stream_of(flow))
    return sums


def warp_labels_dice_flow_grad(labels: torch.Tensor, flow: torch.Tensor, t: torch.Tensor,
                               coef: torch.Tensor, num_classes: int, zeropad: bool = False,
                               impl=None) -> torch.Tensor:
    """The gradient w.r.t. ``flow`` of ``sum g * warp_onehot(labels, flow)``
    for the cotangent ``g = keep (alpha t + beta)``, ``coef (B, L, 2)`` holding
    ``(alpha, beta)``: ``(B, X, Y, Z, 3)`` float32. K7's second entry on the
    card, which reads ``t`` only at each voxel's distinct corner labels."""
    _check_dice(labels, flow, t, num_classes)
    if tuple(coef.shape) != (labels.shape[0], num_classes, 2):
        raise ValueError(f"coef {tuple(coef.shape)} must be (B, L, 2)")
    if not use_kernel(flow, impl):
        return _dice_flow_grad_plain(labels, flow, t, coef, num_classes, zeropad)
    labels = _kernel_labels(labels, flow, t, num_classes, "warp_labels_dice_flow_grad").contiguous()
    flow = flow.detach().float().contiguous()
    t = t.detach().float().contiguous()
    coef = coef.detach().float().contiguous()
    B, X, Y, Z = labels.shape
    gflow = torch.empty_like(flow)
    with kernels.on_device_of(flow):
        kernels.WARP_LABELS_BWD.launch_entry(
            "warp_labels_dice_bwd_launch", t.data_ptr(), labels.data_ptr(), flow.data_ptr(),
            coef.data_ptr(), gflow.data_ptr(), B, X, Y, Z, num_classes, int(zeropad),
            int(labels.dtype == torch.uint8), kernels.stream_of(flow))
    return gflow


def dice_coefficients(sums: torch.Tensor, zeropad: bool = False):
    """From the sums ``(B, L, 3)`` of :func:`warp_labels_dice_sums`: the
    loss (a 0-d tensor, ``losses.dice_loss`` or ``dice_loss_zeropad``) and
    ``coef (B, L, 2)``, its cotangent's ``(alpha, beta)``. On the sums'
    device, without a host synchronisation."""
    I, P, T = sums.unbind(-1)
    S = T + P
    ok = S > 0
    den = torch.where(ok, S, 1.0)
    ratio = torch.where(ok, 2.0 * I / den, 0.0)
    first = 1 if zeropad else 0
    n = ratio.shape[0] * (ratio.shape[1] - first)
    loss = -ratio[:, first:].mean()
    inv = torch.where(ok, 2.0 / (n * den), 0.0)
    coef = torch.stack([-inv, inv * I / den], -1)
    if zeropad:
        coef[:, 0] = 0.0
    return loss, coef


class _WarpOnehotDice(torch.autograd.Function):
    """The Dice loss of a target map against the warped one-hot: K6's and
    K7's Dice entries on the card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, labels, flow, t, num_classes, zeropad):
        sums = warp_labels_dice_sums(labels, flow, t, num_classes, zeropad)
        loss, coef = dice_coefficients(sums, zeropad)
        ctx.save_for_backward(labels, flow, t, coef)
        ctx.num_classes, ctx.zeropad = num_classes, zeropad
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        labels, flow, t, coef = ctx.saved_tensors
        gflow = warp_labels_dice_flow_grad(labels, flow, t, coef * g, ctx.num_classes,
                                           ctx.zeropad)
        return None, gflow, None, None, None


def warp_onehot_dice_batch(labels: torch.Tensor, flow: torch.Tensor, map2: torch.Tensor,
                           num_classes: int, zeropad: bool = False, impl=None) -> torch.Tensor:
    """``(dice_loss_zeropad if zeropad else dice_loss)(map2,
    warp_onehot_batch(labels, flow, num_classes))``, differentiable w.r.t.
    ``flow``, without the warped map or its cotangent: the forward takes the
    Dice sums (K6's Dice entry), the backward forms the cotangent from them
    and ``map2`` inside K7's Dice entry. ``impl="plain"`` is the dense
    composition through the plain versions, the reference; on the CPU the
    fused function runs its kernels' plain versions."""
    _check_dice(labels, flow, map2, num_classes)
    if impl == "plain":
        pred = warp_onehot_batch(labels, flow, num_classes, impl="plain")
        return (dice_loss_zeropad if zeropad else dice_loss)(map2, pred)
    use_kernel(flow, impl)  # refuses an unknown impl
    if needs_grad(map2):
        raise NotImplementedError(
            "warp_onehot_dice_batch has no gradient w.r.t. the target map: use impl='plain'")
    return _WarpOnehotDice.apply(labels.contiguous(), flow.float().contiguous(),
                                 map2.detach().float().contiguous(), int(num_classes),
                                 bool(zeropad))
