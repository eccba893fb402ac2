"""Dense displacement-field algebra: composition and smoothing.

Counterpart of ``multimodal_registration_tpu/ops/field.py``. With the
convention ``moved(x) = img(x + phi(x))``, warping by ``phi1`` then ``phi2``
equals warping by ``phi(x) = phi2(x) + phi1(x + phi2(x))``
(``vxm.utils.compose([phi1, phi2])``). The warp inside is kernel K2 on the
card, so compositions are differentiable through K5.
"""

from __future__ import annotations

import math

import torch

from multimodal_registration_torch.device import constant
from multimodal_registration_torch.ops.warp import warp, warp_batch


def compose_fields(phi1: torch.Tensor, phi2: torch.Tensor, impl=None) -> torch.Tensor:
    """Compose ``(X, Y, Z, 3)`` fields: first ``phi1``, then ``phi2``. The
    gathered values keep ``phi1``'s type (a bfloat16 ``phi1`` is a bfloat16
    payload); the sum is float32."""
    return phi2 + warp(phi1, phi2, interp="linear", impl=impl)


def compose_fields_batch(phi1: torch.Tensor, phi2: torch.Tensor, impl=None) -> torch.Tensor:
    """Batched :func:`compose_fields` over ``(B, X, Y, Z, 3)`` fields."""
    return phi2 + warp_batch(phi1, phi2, interp="linear", impl=impl)


def compose_many(fields, impl=None) -> torch.Tensor:
    """Left fold of :func:`compose_fields` over an ordered list of fields
    (first applied first)."""
    out = fields[0]
    for f in fields[1:]:
        out = compose_fields(out, f, impl=impl)
    return out


def smooth_field(field: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Border-renormalised separable Gaussian smoothing of an ``(X, Y, Z, C)``
    field (``sigma`` in voxels of the field's own grid).

    The blur of the field is divided by the blur of a volume of ones, so
    voxels near the border average only in-bounds neighbours and a constant
    field is an exact fixed point."""
    from multimodal_registration_torch.synth.image_engine import _gaussian_blur

    if sigma <= 0:
        return field
    r = int(math.ceil(3.0 * float(sigma))) if radius is None else int(radius)
    sig = constant(float(sigma), torch.float32, field.device)
    norm = _gaussian_blur(torch.ones(field.shape[:3], dtype=torch.float32, device=field.device),
                          sig, r)
    f = field.float().movedim(-1, 0)  # channels lead: the blur is per channel
    out = _gaussian_blur(f, sig, r, first_axis=1) / norm
    return out.movedim(0, -1).to(field.dtype)


def smooth_field_batch(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Batched :func:`smooth_field` over ``(B, X, Y, Z, C)``."""
    if sigma <= 0:
        return field
    return torch.stack([smooth_field(f, sigma) for f in field])
