"""Stationary-velocity-field integration by scaling and squaring
(``vxm.layers.VecInt(method='ss')``).

Counterpart of ``multimodal_registration_tpu/ops/integrate.py``:
``phi_0 = v / 2**k``, then k times ``phi = phi + warp(phi, phi)``. With a
``payload_dtype`` the warped values are gathered in that type and the warp's
output is rounded to it before the add, exactly where the JAX package rounds
(its ``warp`` returns the payload's type); coordinates and the accumulator
stay float32. Each squaring step is one launch of kernel K2 on the card.
"""

from __future__ import annotations

import torch

from multimodal_registration_torch.ops.warp import warp, warp_batch


def _integrate(vel, int_steps, payload_dtype, warp_fn, impl):
    if int_steps <= 0:
        return vel
    phi = vel.float() / (2.0 ** int_steps)
    for _ in range(int_steps):
        if payload_dtype is not None:
            inc = warp_fn(phi.to(payload_dtype), phi, interp="linear", impl=impl).float()
        else:
            inc = warp_fn(phi, phi, interp="linear", impl=impl)
        phi = phi + inc
    return phi


def integrate_svf(vel: torch.Tensor, int_steps: int = 5, payload_dtype=None,
                  impl=None) -> torch.Tensor:
    """Integrate an SVF ``(X, Y, Z, 3)`` into a displacement field;
    ``int_steps=0`` returns ``vel`` unchanged."""
    return _integrate(vel, int_steps, payload_dtype, warp, impl)


def integrate_svf_batch(vel: torch.Tensor, int_steps: int = 5, payload_dtype=None,
                        impl=None) -> torch.Tensor:
    """Batched :func:`integrate_svf` over ``(B, X, Y, Z, 3)`` fields."""
    return _integrate(vel, int_steps, payload_dtype, warp_batch, impl)
