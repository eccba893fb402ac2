"""Dense-displacement spatial transformer: the wrappers of kernels K2
(``warp_trilinear``) and K3 (``warp_up2x``), with their plain versions.

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
                term = gather(ix, iy, iz).float() * (wx * wy * wz)[..., None]
                out = term if out is None else out + term
    return out.to(vol.dtype)


def _clip(c: torch.Tensor, X: int, Y: int, Z: int) -> torch.Tensor:
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=c.dtype, device=c.device)
    return torch.minimum(torch.clamp(c, min=0.0), hi)


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
    out = torch.empty((B, N, C), dtype=vol5.dtype, device=vol5.device)
    Yo, Zo = (out_grid[1], out_grid[2]) if coords_are_flow else (1, 1)
    with torch.cuda.device(vol5.device):
        kernels.WARP_TRILINEAR.launch(
            vol5.data_ptr(), coords.data_ptr(), out.data_ptr(), B, X, Y, Z, C,
            N, Yo, Zo, int(coords_are_flow), int(interp == "nearest"),
            int(vol5.dtype == torch.bfloat16), kernels.stream_of(vol5))
    return out


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
