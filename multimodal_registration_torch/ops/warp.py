"""Dense-displacement spatial transformer: the wrappers of kernels K2
(``warp_trilinear``), K3 (``warp_up2x``), K5 (``warp_trilinear_bwd``), K6
(``warp_labels_soft_hard``) and K7 (its backward), with their plain versions.

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
is K7. K3 has no backward yet and raises when a gradient is asked of it. The
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
"""

from __future__ import annotations

import torch

from multimodal_registration_torch import kernels
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


def _launch_warp(vol5, coords, Yo, Zo, coords_are_flow, nearest):
    """Launch K2 on contiguous CUDA tensors: ``vol5 (B, X, Y, Z, C)``,
    ``coords (B, N, 3)`` float32 -> ``(B, N, C)``."""
    B, X, Y, Z, C = vol5.shape
    N = coords.shape[1]
    out = torch.empty((B, N, C), dtype=vol5.dtype, device=vol5.device)
    with torch.cuda.device(vol5.device):
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
    def backward(ctx, gout):
        vol5, coords = ctx.saved_tensors
        Yo, Zo, coords_are_flow, nearest = ctx.meta
        B, X, Y, Z, C = vol5.shape
        N = coords.shape[1]
        want_vol = ctx.needs_input_grad[0]
        want_coords = ctx.needs_input_grad[1] and not nearest
        gvol = gcoords = None
        if want_vol:
            gvol = torch.zeros(vol5.shape, dtype=torch.float32, device=vol5.device)
        if want_coords:
            gcoords = torch.empty_like(coords)
        if want_vol or want_coords:
            gout = gout.to(vol5.dtype).contiguous()
            with torch.cuda.device(vol5.device):
                kernels.WARP_TRILINEAR_BWD.launch(
                    vol5.data_ptr(), coords.data_ptr(), gout.data_ptr(),
                    gvol.data_ptr() if want_vol else None,
                    gcoords.data_ptr() if want_coords else None,
                    B, X, Y, Z, C, N, Yo, Zo, int(coords_are_flow), int(nearest),
                    int(vol5.dtype == torch.bfloat16), kernels.stream_of(vol5))
        if want_vol:
            gvol = gvol.to(vol5.dtype)  # the float32 sums, rounded once
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
                "warp_up2x (kernel K3) has no backward yet (ROADMAP queue 2, K3's "
                "backward): call it under torch.no_grad(), or use warp_batch on the "
                "rescaled field where a gradient is needed")
        _check_payload(v5, "warp_up2x")
        v5 = v5.contiguous()
        fh = flow_half.float().contiguous()
        if fh.device != v5.device:
            raise ValueError("warp_up2x: volume and field on different devices")
        if B * X * Y * Z * C >= 2**31:
            raise ValueError("warp_up2x: tensor too large for 32-bit voxel indices")
        out = torch.empty_like(v5)
        with torch.cuda.device(v5.device):
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


def _warp_labels_plain(labels, flow, num_classes):
    """Plain version of K6, differentiable w.r.t. ``flow`` by autograd (which
    is the plain version of K7). Labels must lie in ``[0, num_classes)``."""
    B, X, Y, Z = labels.shape
    N = X * Y * Z
    grid = identity_grid((X, Y, Z), device=flow.device).reshape(1, N, 3)
    c = _clip(grid + flow.float().reshape(B, N, 3), X, Y, Z)
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
    soft = torch.zeros((B, N, num_classes), dtype=torch.float32, device=flow.device)
    soft = soft.scatter_add(2, torch.stack(labs, -1), torch.stack(ws, -1))
    r = torch.round(c.detach()).long()  # half to even, like jnp.round
    hard = torch.gather(flat, 1, (r[..., 0] * Y + r[..., 1]) * Z + r[..., 2])
    return soft.reshape(B, X, Y, Z, num_classes), hard.reshape(B, X, Y, Z).to(torch.int32)


class _WarpLabels(torch.autograd.Function):
    """K6 forward, K7 backward, on contiguous CUDA tensors."""

    @staticmethod
    def forward(ctx, labels, flow, num_classes):
        B, X, Y, Z = labels.shape
        soft = torch.empty((B, X, Y, Z, num_classes), dtype=torch.float32, device=flow.device)
        hard = torch.empty((B, X, Y, Z), dtype=torch.int32, device=flow.device)
        with torch.cuda.device(flow.device):
            kernels.WARP_LABELS.launch(
                labels.data_ptr(), flow.data_ptr(), soft.data_ptr(), hard.data_ptr(),
                B, X, Y, Z, num_classes, int(labels.dtype == torch.uint8),
                kernels.stream_of(flow))
        ctx.save_for_backward(labels, flow)
        ctx.num_classes = num_classes
        ctx.mark_non_differentiable(hard)
        return soft, hard

    @staticmethod
    def backward(ctx, gsoft, _ghard):
        labels, flow = ctx.saved_tensors
        B, X, Y, Z = labels.shape
        gflow = torch.empty_like(flow)
        gsoft = gsoft.float().contiguous()
        with torch.cuda.device(flow.device):
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
