"""Separable corner-aligned trilinear resize (Neurite's ``ne.utils.resize``).

Counterpart of ``multimodal_registration_tpu/ops/resize.py``. Neurite maps
output voxel ``i`` to input coordinate ``i / zoom``, corner-aligned at the
origin and edge-clamped at the far side. ``F.interpolate`` follows neither
of its conventions (``align_corners`` True or False both differ), so the 2x
interleave and the interpolation matrices are written out here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multimodal_registration_torch.device import constant, full_fp32_matmuls


@functools.lru_cache(maxsize=128)
def _interp_matrix(n_out: int, n_in: int, zoom: float) -> np.ndarray:
    """M[i, j] weights so that out = M @ in samples in[i / zoom], edge-clamped."""
    x = np.arange(n_out, dtype=np.float64) / zoom
    x = np.clip(x, 0, n_in - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = x - lo
    M = np.zeros((n_out, n_in), dtype=np.float32)
    M[np.arange(n_out), lo] += (1.0 - w_hi).astype(np.float32)
    M[np.arange(n_out), hi] += w_hi.astype(np.float32)
    return M


def _upsample2x_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact corner-aligned 2x linear upsample along one axis:
    ``out[2i] = v[i]``, ``out[2i+1] = (v[i] + v[i+1]) / 2``, edge-clamped."""
    n = v.shape[axis]
    nxt = torch.cat([v.narrow(axis, 1, n - 1), v.narrow(axis, n - 1, 1)], dim=axis)
    mid = 0.5 * (v + nxt)
    out = torch.stack([v, mid], dim=axis + 1)
    return out.reshape(*v.shape[:axis], 2 * n, *v.shape[axis + 1:])


def _float(v: torch.Tensor) -> torch.Tensor:
    return v if v.is_floating_point() else v.float()


def resize(vol: torch.Tensor, zoom, out_shape=None) -> torch.Tensor:
    """Resize the spatial dims of ``(X, Y, Z[, C])`` by ``zoom`` (scalar or
    3-sequence)."""
    squeeze = vol.ndim == 3
    if squeeze:
        vol = vol[..., None]
    if np.isscalar(zoom):
        zoom = (zoom, zoom, zoom)
    in_shape = tuple(vol.shape[:3])
    if out_shape is None:
        out_shape = tuple(int(round(s * z)) for s, z in zip(in_shape, zoom))
    out_shape = tuple(int(s) for s in out_shape)

    if all(float(z) == 2.0 for z in zoom) and out_shape == tuple(2 * s for s in in_shape):
        v = _float(vol)
        for ax in (2, 1, 0):  # the JAX package's order: same rounding
            v = _upsample2x_axis(v, ax)
        return v[..., 0] if squeeze else v
    if (all(float(z) == 0.5 for z in zoom)
            and all(s % 2 == 0 for s in in_shape)
            and out_shape == tuple(s // 2 for s in in_shape)):
        v = _float(vol[::2, ::2, ::2])  # the zoom-0.5 matrix is a stride-2 pick
        return v[..., 0] if squeeze else v

    v = _float(vol)
    mats = [
        torch.as_tensor(_interp_matrix(o, s, float(z)), device=v.device).to(v.dtype)
        for o, s, z in zip(out_shape, in_shape, zoom)
    ]
    # full float32 on the card whatever the caller's TF32 setting
    with full_fp32_matmuls():
        v = torch.einsum("ax,xyzd->ayzd", mats[0], v)
        v = torch.einsum("by,xyzd->xbzd", mats[1], v)
        v = torch.einsum("cz,xyzd->xycd", mats[2], v)
    return v[..., 0] if squeeze else v


def rescale_field(flow: torch.Tensor, factor, out_shape=None) -> torch.Tensor:
    """Resize a displacement field ``(X, Y, Z, 3)`` and scale its vectors by
    ``factor`` (``vxm.layers.RescaleTransform`` parity)."""
    f3 = (factor, factor, factor) if np.isscalar(factor) else tuple(factor)
    out = resize(flow, f3, out_shape=out_shape)
    return out * vector_factors(f3, out)


def vector_factors(f3: tuple, like: torch.Tensor):
    """The operand that scales ``like``'s vectors by ``f3``, with the bits of
    the product by ``torch.tensor(f3, dtype=like.dtype)``: equal factors as one
    Python number rounded to ``like``'s type, others as a constant on
    ``like``'s device (:func:`device.constant`). Neither copies from the host
    on a call."""
    f3 = tuple(float(f) for f in f3)
    if f3[0] == f3[1] == f3[2]:
        return torch.tensor(f3[0], dtype=like.dtype).item()
    return constant(f3, like.dtype, like.device)
