"""Gradients of the port's warp family (through the plain versions of kernels
K2/K5 and K6/K7, which is what a CPU tensor runs) against ``jax.grad`` of the
JAX package's counterparts, on the same numpy inputs.

Tolerances: float32 sums in another order, atol/rtol 1e-5 (1e-4 through five
squaring steps). The JAX side runs its production sampler
(``MMREG_WARP_MODE=packed``): its CPU default ("blockgather") has another
gradient exactly on the far bound (see the port's ``ops/warp.py``). With a bfloat16 payload both packages round the warp's
output and carry a bfloat16 cotangent into a bfloat16 scatter-add, in another
order: a few bf16 ulp of the largest gradient. Hard labels: exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.ops import field as jfield
from multimodal_registration_tpu.ops import integrate as jint
from multimodal_registration_torch.ops import field as tfield
from multimodal_registration_torch.ops import integrate as tint
from multimodal_registration_torch.ops import warp as tw

from _torch_port import bf16_ulp, rand, t

# the JAX ops package exports a function named ``warp`` over its module
jwarp = importlib.import_module("multimodal_registration_tpu.ops.warp")

SHAPE = (2, 10, 8, 12)


@pytest.fixture(autouse=True)
def jax_production_sampler(monkeypatch):
    monkeypatch.setenv("MMREG_WARP_MODE", "packed")


def weights(shape):
    """Fixed cotangent of a test's output."""
    return np.random.default_rng(99).normal(size=shape).astype(np.float32)


def torch_grads(fn, *arrays, dtypes=None):
    dtypes = dtypes or [torch.float32] * len(arrays)
    leaves = [t(a, d).requires_grad_() for a, d in zip(arrays, dtypes)]
    out = fn(*leaves)
    (out.float() * t(weights(out.shape))).sum().backward()
    return [l.grad.float().numpy() for l in leaves]


def jax_grads(fn, *arrays, dtypes=None):
    dtypes = dtypes or [jnp.float32] * len(arrays)

    def scalar(*xs):
        out = fn(*xs)
        return jnp.sum(out.astype(jnp.float32) * weights(out.shape))

    xs = [jnp.asarray(a, d) for a, d in zip(arrays, dtypes)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(scalar, argnums=tuple(range(len(xs))))(*xs)]


def test_warp_batch_gradients_wrt_volume_and_flow():
    vol = rand((*SHAPE, 3), 1)
    flow = rand((*SHAPE, 3), 2, low=-5.0, high=5.0)
    gv, gf = torch_grads(lambda v, f: tw.warp_batch(v, f), vol, flow)
    jv, jf = jax_grads(lambda v, f: jwarp.warp_batch(v, f), vol, flow)
    np.testing.assert_allclose(gv, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gf, jf, atol=1e-5, rtol=1e-5)
    assert np.abs(gf).max() > 0.1 and (gf == 0).any()  # clipped voxels pass nothing


def test_zero_flow_clip_gradient_follows_the_jax_rule():
    """A border voxel with zero displacement sits exactly on the clip's bound:
    JAX passes half the derivative there, ``torch.clamp`` would pass all."""
    vol = rand((1, 6, 5, 7, 2), 3)
    flow = np.zeros((1, 6, 5, 7, 3), np.float32)
    (gf,) = torch_grads(lambda f: tw.warp_batch(t(vol), f), flow)
    (jf,) = jax_grads(lambda f: jwarp.warp_batch(jnp.asarray(vol), f), flow)
    np.testing.assert_allclose(gf, jf, atol=1e-6, rtol=1e-6)
    w = weights((1, 6, 5, 7, 2))
    want = 0.5 * ((vol[0, 1, 2, 2] - vol[0, 0, 2, 2]) * w[0, 0, 2, 2]).sum()
    np.testing.assert_allclose(gf[0, 0, 2, 2, 0], want, atol=1e-6, rtol=1e-5)
    assert np.all(gf[0, -1, :, :, 0] == 0)  # i1 == i0 on the far bound: no slope


def test_nearest_warp_has_a_volume_gradient_only():
    vol = rand((*SHAPE, 2), 4)
    flow = rand((*SHAPE, 3), 5, low=-3.0, high=3.0)
    gv, = torch_grads(lambda v: tw.warp_batch(v, t(flow), interp="nearest"), vol)
    jv, = jax_grads(lambda v: jwarp.warp_batch(v, jnp.asarray(flow), interp="nearest"), vol)
    np.testing.assert_allclose(gv, jv, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("payload", ["", "bfloat16"])
def test_integrate_svf_batch_gradient(payload):
    vel = rand((*SHAPE, 3), 6, 1.5)
    tpd = getattr(torch, payload) if payload else None
    jpd = jnp.dtype(payload) if payload else None
    (gt,) = torch_grads(lambda v: tint.integrate_svf_batch(v, 5, tpd), vel)
    (gj,) = jax_grads(lambda v: jint.integrate_svf_batch(v, 5, payload_dtype=jpd), vel)
    if payload:
        np.testing.assert_allclose(gt, gj, rtol=0, atol=8 * bf16_ulp(np.abs(gj).max()))
    else:
        np.testing.assert_allclose(gt, gj, atol=1e-4, rtol=1e-4)


def test_compose_fields_batch_values_and_gradients():
    phi1 = rand((*SHAPE, 3), 7, 2.0)
    phi2 = rand((*SHAPE, 3), 8, 2.0)
    got = tfield.compose_fields_batch(t(phi1), t(phi2)).numpy()
    want = np.asarray(jfield.compose_fields_batch(jnp.asarray(phi1), jnp.asarray(phi2)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    g1, g2 = torch_grads(tfield.compose_fields_batch, phi1, phi2)
    j1, j2 = jax_grads(jfield.compose_fields_batch, phi1, phi2)
    np.testing.assert_allclose(g1, j1, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g2, j2, atol=1e-5, rtol=1e-5)
    # unbatched and folded forms
    many = tfield.compose_many([t(phi1[0]), t(phi2[0]), t(phi1[1])]).numpy()
    jmany = np.asarray(jfield.compose_many([jnp.asarray(phi1[0]), jnp.asarray(phi2[0]),
                                            jnp.asarray(phi1[1])]))
    np.testing.assert_allclose(many, jmany, atol=1e-5, rtol=1e-5)


def test_compose_with_bf16_payload_sums_in_float32():
    phi1 = rand((*SHAPE, 3), 9, 3.0)
    phi2 = rand((*SHAPE, 3), 10, 2.0)
    got = tfield.compose_fields_batch(t(phi1, torch.bfloat16), t(phi2))
    want = jfield.compose_fields_batch(jnp.asarray(phi1, jnp.bfloat16), jnp.asarray(phi2))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=bf16_ulp(np.abs(phi1).max()))


@pytest.mark.parametrize("ldtype", [torch.uint8, torch.int32])
def test_warp_labels_soft_hard_forward(ldtype):
    L = 6
    labels = np.random.default_rng(11).integers(0, L, SHAPE[1:])
    flow = rand((*SHAPE[1:], 3), 12, low=-4.0, high=4.0)
    soft, hard = tw.warp_labels_soft_hard(torch.as_tensor(labels, dtype=ldtype), t(flow), L)
    jsoft, jhard = jwarp.warp_labels_soft_hard(jnp.asarray(labels, jnp.int32),
                                               jnp.asarray(flow), L)
    assert hard.dtype == torch.int32 and soft.dtype == torch.float32
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jhard))
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), atol=1e-6, rtol=0)


def test_hard_labels_round_half_to_even_on_the_clipped_coordinate():
    L = 5
    labels = np.random.default_rng(13).integers(0, L, (9, 8, 10))
    flow = np.full((9, 8, 10, 3), 0.5, np.float32)
    _, hard = tw.warp_labels_soft_hard(torch.as_tensor(labels, dtype=torch.uint8), t(flow), L)
    _, jhard = jwarp.warp_labels_soft_hard(jnp.asarray(labels, jnp.int32), jnp.asarray(flow), L)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jhard))
    assert hard[2, 2, 2] == labels[2, 2, 2] and hard[1, 1, 1] == labels[2, 2, 2]


def test_warp_onehot_gradient_wrt_flow():
    L = 6
    labels = np.random.default_rng(14).integers(0, L, SHAPE)
    flow = rand((*SHAPE, 3), 15, low=-4.0, high=4.0)
    flow[0, :2] = 0.0  # voxels that sit exactly on the clip's lower bound
    lt = torch.as_tensor(labels, dtype=torch.uint8)
    (gt,) = torch_grads(lambda f: tw.warp_onehot_batch(lt, f, L), flow)
    jl = jnp.asarray(labels, jnp.int32)
    (gj,) = jax_grads(lambda f: jax.vmap(lambda l, ff: jwarp.warp_onehot(l, ff, L))(jl, f), flow)
    np.testing.assert_allclose(gt, gj, atol=1e-5, rtol=1e-5)
    assert np.abs(gt).max() > 0.1 and (gt[0, 0] != 0).any()


def test_gradcheck_float64_on_the_plain_versions():
    """Away from integer coordinates and bounds the functions are smooth."""
    rng = np.random.default_rng(16)
    vol = torch.as_tensor(rng.normal(size=(1, 5, 4, 6, 2)), dtype=torch.float64).requires_grad_()
    frac = rng.uniform(0.2, 0.8, size=(1, 5, 4, 6, 3)) + rng.integers(-1, 2, size=(1, 5, 4, 6, 3))
    flow = torch.as_tensor(frac, dtype=torch.float64).requires_grad_()

    def warp64(v, f):  # the plain sampler on float64 coordinates
        B, X, Y, Z, _ = v.shape
        grid = tw.identity_grid((X, Y, Z), dtype=torch.float64).reshape(1, -1, 3)
        return tw._sample_plain(v, tw._clip(grid + f.reshape(B, -1, 3), X, Y, Z), "linear")

    assert torch.autograd.gradcheck(warp64, (vol, flow), eps=1e-6, atol=1e-5)


def test_inference_kernels_wrappers_keep_the_cpu_path_differentiable():
    # on the CPU the wrappers run their plain versions, which autograd follows
    vol = t(rand((1, 8, 8, 8, 1), 17)).requires_grad_()
    fh = t(rand((1, 4, 4, 4, 3), 18)).requires_grad_()
    tw.warp_up2x_batch(vol, fh).sum().backward()
    assert vol.grad is not None and float(fh.grad.abs().max()) > 0
