"""The fused squaring step of the port (``ops/warp.py::self_warp_add_batch``,
on the CPU its plain version) against the JAX package: one step of
``ops/integrate.py::_integrate``'s body, the 5-step integration, and their
gradients, on the same numpy inputs.

Tolerances. One float32 step: 1e-6 voxel (one trilinear mix whose corner sum
differs in order). Five float32 steps: 1e-5 (the differences compound through
the compositions). bf16 payload: both sides round the warp's output to bf16,
and a last-bit difference of the float32 mix can flip that rounding: 1 bf16 ulp
of the field's magnitude for one step, 4 for five. Gradients: float32 1e-5
(1e-4 through five steps); bf16 payload a few bf16 ulp of the largest gradient
(both sides scatter a bf16 cotangent in bf16, in another order). The JAX side
of a gradient runs its production sampler (``MMREG_WARP_MODE=packed``): its CPU
default has another gradient exactly on the far clip bound."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.ops import integrate as jint
from multimodal_registration_torch.ops import integrate as tint
from multimodal_registration_torch.ops import warp as tw

from _torch_port import bf16_ulp, rand, t

jwarp = importlib.import_module("multimodal_registration_tpu.ops.warp")

SHAPE = (2, 10, 8, 12)
PAYLOADS = [None, "bfloat16"]


@pytest.fixture()
def jax_production_sampler(monkeypatch):
    monkeypatch.setenv("MMREG_WARP_MODE", "packed")


def _dtypes(payload):
    return (getattr(torch, payload), jnp.dtype(payload)) if payload else (None, None)


def jax_step(p, jpd):
    """One pass of the body of the JAX package's ``_integrate``."""
    if jpd is not None:
        return p + jwarp.warp_batch(p.astype(jpd), p, interp="linear").astype(jnp.float32)
    return p + jwarp.warp_batch(p, p, interp="linear")


def weights(shape):
    return np.random.default_rng(99).normal(size=shape).astype(np.float32)


def torch_grad(fn, a):
    leaf = t(a).requires_grad_()
    (fn(leaf) * t(weights(a.shape))).sum().backward()
    return leaf.grad.numpy()


def jax_grad(fn, a):
    return np.asarray(jax.grad(lambda x: jnp.sum(fn(x) * weights(a.shape)))(jnp.asarray(a)))


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("amp", [0.1, 3.0, 30.0])
def test_self_warp_add_matches_one_jax_squaring_step(payload, amp):
    phi = rand((*SHAPE, 3), 1, low=-amp, high=amp)
    tpd, jpd = _dtypes(payload)
    got = tw.self_warp_add_batch(t(phi), tpd)
    want = np.asarray(jax_step(jnp.asarray(phi), jpd))
    assert got.dtype == torch.float32 and got.shape == phi.shape
    tol = 1e-6 * max(amp, 1.0) if payload is None else bf16_ulp(np.abs(phi).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_self_warp_add_is_the_four_operations_bit_for_bit(payload):
    """The plain version is the cast, the warp, the cast back and the add."""
    phi = t(rand((*SHAPE, 3), 2, low=-4.0, high=4.0))
    tpd, _ = _dtypes(payload)
    if tpd is None:
        want = phi + tw.warp_batch(phi, phi)
    else:
        want = phi + tw.warp_batch(phi.to(tpd), phi).float()
    assert torch.equal(tw.self_warp_add_batch(phi, tpd), want)
    assert torch.equal(tw.self_warp_add_batch(phi, tpd, impl="plain"), want)


def test_float32_payload_is_the_default_payload():
    phi = t(rand((*SHAPE, 3), 3, 2.0))
    assert torch.equal(tw.self_warp_add_batch(phi, torch.float32), tw.self_warp_add_batch(phi))


@pytest.mark.parametrize("payload", PAYLOADS)
def test_five_steps_match_jax_integrate_svf_batch(payload):
    v = rand((2, 4, 4, 5, 3), 4, low=-3.0, high=3.0)
    vel = np.repeat(np.repeat(np.repeat(v, 3, 1), 3, 2), 3, 3)  # smooth-ish, (2, 12, 12, 15, 3)
    tpd, jpd = _dtypes(payload)
    want = np.asarray(jint.integrate_svf_batch(jnp.asarray(vel), 5, payload_dtype=jpd))
    got = tint.integrate_svf_batch(t(vel), 5, payload_dtype=tpd).numpy()
    tol = 1e-5 if payload is None else 4 * bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the loop is the fused step, five times, from v / 32
    phi = t(vel) / 32.0
    for _ in range(5):
        phi = tw.self_warp_add_batch(phi, tpd)
    np.testing.assert_array_equal(got, phi.numpy())


@pytest.mark.parametrize("payload", PAYLOADS)
def test_unbatched_integration_is_the_batched_one(payload):
    vel = t(rand((9, 8, 10, 3), 5, 2.0))
    tpd, _ = _dtypes(payload)
    assert torch.equal(tint.integrate_svf(vel, 3, tpd),
                       tint.integrate_svf_batch(vel[None], 3, tpd)[0])


@pytest.mark.parametrize("payload", PAYLOADS)
def test_self_warp_add_gradient_matches_jax(jax_production_sampler, payload):
    phi = rand((*SHAPE, 3), 6, low=-5.0, high=5.0)
    tpd, jpd = _dtypes(payload)
    gt = torch_grad(lambda p: tw.self_warp_add_batch(p, tpd), phi)
    gj = jax_grad(lambda p: jax_step(p, jpd), phi)
    if payload:
        np.testing.assert_allclose(gt, gj, rtol=0, atol=4 * bf16_ulp(np.abs(gj).max()))
    else:
        np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=1e-5)
    assert np.abs(gt - weights(phi.shape)).max() > 0.1  # more than the identity term


@pytest.mark.parametrize("payload", PAYLOADS)
def test_zero_field_gradient_has_the_clips_one_half_on_the_bound(jax_production_sampler, payload):
    """Every border voxel of a zero field sits exactly on a clip bound. The
    field's values are zero too, so the term through the weights vanishes and
    what is compared is the identity term plus the scatter; the next test
    has border planes on the bound with a field that is not zero."""
    phi = np.zeros((1, 6, 5, 7, 3), np.float32)
    tpd, jpd = _dtypes(payload)
    gt = torch_grad(lambda p: tw.self_warp_add_batch(p, tpd), phi)
    gj = jax_grad(lambda p: jax_step(p, jpd), phi)
    tol = 1e-6 if payload is None else 2 * bf16_ulp(np.abs(gj).max())
    np.testing.assert_allclose(gt, gj, atol=tol, rtol=0)


def test_border_rows_of_zero_displacement_pass_half_the_slope(jax_production_sampler):
    """x-displacement zero on the x = 0 plane (on the lower bound: one half of
    the slope) and on the last plane (i1 == i0: none), other components
    random: the gradient through the weights follows the JAX rule."""
    phi = rand((1, 6, 5, 7, 3), 7, low=-1.5, high=1.5)
    phi[0, 0, :, :, 0] = 0.0
    phi[0, -1, :, :, 0] = 0.0
    gt = torch_grad(lambda p: tw.self_warp_add_batch(p), phi)
    gj = jax_grad(lambda p: jax_step(p, None), phi)
    np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_integration_gradient_through_the_fused_steps(jax_production_sampler, payload):
    vel = rand((*SHAPE, 3), 8, 1.5)
    tpd, jpd = _dtypes(payload)
    gt = torch_grad(lambda v: tint.integrate_svf_batch(v, 5, tpd), vel)
    gj = jax_grad(lambda v: jint.integrate_svf_batch(v, 5, payload_dtype=jpd), vel)
    if payload:
        np.testing.assert_allclose(gt, gj, rtol=0, atol=8 * bf16_ulp(np.abs(gj).max()))
    else:
        np.testing.assert_allclose(gt, gj, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad, error", [
    (torch.zeros((6, 5, 7, 3)), ValueError),                          # no batch axis
    (torch.zeros((1, 6, 5, 7, 2)), ValueError),                       # not a displacement field
    (torch.zeros((1, 6, 5, 7, 3), dtype=torch.bfloat16), TypeError),  # the field is float32
])
def test_self_warp_add_refuses_what_is_not_a_float32_field(bad, error):
    with pytest.raises(error):
        tw.self_warp_add_batch(bad)
    with pytest.raises(ValueError, match="impl"):
        tw.self_warp_add_batch(torch.zeros((1, 4, 4, 4, 3)), impl="kernel")


def test_scratch_buffer_is_cached_and_a_dirty_one_is_zeroed(monkeypatch):
    """K5's scratch buffer: one per device, stream and size, handed out
    marked; a buffer still marked (a backward failed between its kernels) is
    zeroed before it is handed out again."""
    monkeypatch.setattr(tw.kernels, "stream_of", lambda _t: 0)
    monkeypatch.setattr(tw, "_SCRATCH", {})
    like = torch.zeros(1)
    first = tw._scratch(like, 24)
    assert first[1] and first[0].shape == (24,) and float(first[0].abs().max()) == 0.0
    first[0].fill_(3.0)                      # the kernels' sums; no finish pass ran
    again = tw._scratch(like, 24)
    assert again is first and float(again[0].abs().max()) == 0.0
    again[1] = False                         # what the wrapper does after the finish pass
    again[0][0] = 1.0                        # (would be the kernels' business)
    assert tw._scratch(like, 24)[0][0] == 1.0  # a clean buffer is not touched
    assert tw._scratch(like, 48) is not first
    assert len(tw.scratch_buffers()) == 2
    for n in range(100, 110):                # the cache does not grow without bound
        tw._scratch(like, n)
    assert len(tw.scratch_buffers()) <= 8
    newest = tw._scratch(like, 109)          # a full cache drops its oldest entry only
    tw._scratch(like, 200)
    assert tw._scratch(like, 109) is newest


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("amp", [1.5, 40.0])
def test_float64_formula_of_the_backward_agrees_with_autograd_of_the_plain_version(payload, amp):
    """``self_warp_add_grad_float64`` is the yardstick of the card tests: with
    a float32 payload it differs from autograd of the plain version by the
    summation order alone; with a bf16 payload by the plain version's rounding
    of every contribution (a few bf16 ulp of the largest gradient)."""
    tpd, _ = _dtypes(payload)
    phi = t(rand((2, 9, 7, 10, 3), 70, low=-amp, high=amp))
    g = t(weights(tuple(phi.shape)))
    leaf = phi.clone().requires_grad_()
    tw.self_warp_add_batch(leaf, tpd).backward(g)
    ref = tw.self_warp_add_grad_float64(phi, g, tpd)
    m = float(ref.abs().max())
    assert ref.dtype == torch.float32 and ref.shape == phi.shape
    tol = 1e-6 * max(m, 1.0) if payload is None else 4 * bf16_ulp(m)
    torch.testing.assert_close(leaf.grad, ref, atol=tol, rtol=0)
