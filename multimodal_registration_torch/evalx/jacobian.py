"""Jacobian-determinant folding analysis of dense deformation fields, the
determinants on the device.

Counterpart of ``multimodal_registration_tpu/evalx/jacobian.py``: 4th-order
central differences (5-point stencil, 2-voxel border trim) of the
displacement field in float32, J = I + grad(phi), det(J) per voxel by the
explicit 3x3 expression in the JAX package's order; the share of negative
determinants (folding) and median / mean / std of the determinant volume
are taken on the host with numpy, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device


def _stencil(f: torch.Tensor, axis: int) -> torch.Tensor:
    sl = [slice(2, -2)] * 3
    out = []
    for off in (-2, -1, 1, 2):
        s = list(sl)
        s[axis] = slice(2 + off, f.shape[axis] - 2 + off or None)
        out.append(f[tuple(s)])
    m2, m1, p1, p2 = out
    return (m2 - 8.0 * m1 + 8.0 * p1 - p2) / 12.0


@torch.inference_mode()
def _jacobian_det(ddf: torch.Tensor) -> torch.Tensor:
    """``ddf (X, Y, Z, 3)`` -> ``det J (X-4, Y-4, Z-4)``."""
    J = torch.stack([_stencil(ddf, 0), _stencil(ddf, 1), _stencil(ddf, 2)], dim=-1)
    J = J + torch.eye(3, dtype=ddf.dtype, device=ddf.device)
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def jacobian_determinant(ddf: np.ndarray, device=None) -> np.ndarray:
    """Accepts ``(X, Y, Z, 3)`` or the NIfTI field layout ``(X, Y, Z, 1,
    3)``; returns the float32 determinants on the host."""
    arr = np.asarray(ddf, np.float32)
    if arr.ndim == 5:
        arr = arr[:, :, :, 0, :]
    t = torch.as_tensor(np.ascontiguousarray(arr), device=resolve_device(device))
    return _jacobian_det(t).cpu().numpy()


def folding_summary(ddf: np.ndarray, device=None) -> dict:
    det = jacobian_determinant(ddf, device)
    flat = det.reshape(-1)
    negatives = int(np.count_nonzero(flat < 0))
    return {
        "det": det,
        "percentage_negative_detJa": 100.0 * negatives / flat.size,
        "median_detJa": float(np.median(flat)),
        "mean_detJa": float(np.mean(flat)),
        "std_detJa": float(np.std(flat)),
        "n_total_detJa": int(flat.size),
        "n_negatives_detJa": negatives,
    }
