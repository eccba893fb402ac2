"""Stationary-velocity-field integration by scaling and squaring
(``vxm.layers.VecInt(method='ss')``).

Counterpart of ``multimodal_registration_tpu/ops/integrate.py``:
``phi_0 = v / 2**k``, then k times ``phi = phi + warp(phi, phi)``. With a
``payload_dtype`` the warped values are gathered in that type and the warp's
output is rounded to it before the add, exactly where the JAX package rounds
(its ``warp`` returns the payload's type); coordinates and the accumulator
stay float32. Each squaring step is one launch on the card: the fused entry
of kernel K2 (``ops/warp.py::self_warp_add_batch``), which reads the field
once, as coordinates and as payload, and equals the cast, the warp, the cast
back and the add bit for bit.
"""

from __future__ import annotations

import torch

from multimodal_registration_torch.ops.warp import self_warp_add_batch


def _integrate(vel, int_steps, payload_dtype, impl):
    if int_steps <= 0:
        return vel
    phi = vel.float() / (2.0 ** int_steps)
    for _ in range(int_steps):
        phi = self_warp_add_batch(phi, payload_dtype, impl=impl)
    return phi


def integrate_svf(vel: torch.Tensor, int_steps: int = 5, payload_dtype=None,
                  impl=None) -> torch.Tensor:
    """Integrate an SVF ``(X, Y, Z, 3)`` into a displacement field;
    ``int_steps=0`` returns ``vel`` unchanged."""
    return _integrate(vel[None], int_steps, payload_dtype, impl)[0]


def integrate_svf_batch(vel: torch.Tensor, int_steps: int = 5, payload_dtype=None,
                        impl=None) -> torch.Tensor:
    """Batched :func:`integrate_svf` over ``(B, X, Y, Z, 3)`` fields."""
    return _integrate(vel, int_steps, payload_dtype, impl)
