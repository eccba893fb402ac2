"""Port ``ops/integrate.py`` against the JAX package's: scaling and squaring,
5 steps, float32 and bfloat16 payload.

Tolerances: float32 atol 1e-5 voxel (five compositions of float32 trilinear
mixes whose corner sums differ in order). bf16 payload: each step rounds
the warped field to bf16 on both sides, and a last-bit difference of the
float32 mix can flip that rounding by one bf16 ulp; over 5 steps the
difference stays within 4 ulps of the field's magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.ops import integrate as ji
from multimodal_registration_torch.ops import integrate as ti

from _torch_port import bf16_ulp, rand, t


def _svf(batch, seed, amp=3.0):
    # smooth-ish: random low-res field upsampled, like a U-Net's SVF
    v = rand((batch, 4, 4, 5, 3), seed, low=-amp, high=amp)
    return np.repeat(np.repeat(np.repeat(v, 3, 1), 3, 2), 3, 3)  # (B, 12, 12, 15, 3)


@pytest.mark.parametrize("payload", [None, "bfloat16"])
def test_integrate_svf_batch_matches_jax(payload):
    vel = _svf(2, 0)
    jpd = jnp.bfloat16 if payload else None
    tpd = torch.bfloat16 if payload else None
    want = np.asarray(ji.integrate_svf_batch(jnp.asarray(vel), 5, payload_dtype=jpd))
    got = ti.integrate_svf_batch(t(vel), 5, payload_dtype=tpd).numpy()
    tol = 1e-5 if payload is None else 4 * bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_integrate_svf_unbatched_and_zero_steps():
    vel = _svf(1, 1)[0]
    want = np.asarray(jax.vmap(lambda v: ji.integrate_svf(v, 5))(jnp.asarray(vel[None])))[0]
    got = ti.integrate_svf(t(vel), 5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ti.integrate_svf(t(vel), 0).numpy(), vel)
