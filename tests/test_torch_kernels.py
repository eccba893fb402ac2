"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Without a card every test here skips: a CUDA kernel has no CPU mode.
This file imports nothing of JAX, so the machine with the card (which has no
JAX) runs it on its own:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

Tolerances: K2 and K3 repeat their plain versions' float32 operations in the
same order without FMA contraction, so they match exactly (K3: 1e-5 for the
upsample's sums). K1: float32 atol 1e-5 (a 54-term sum in another order than
cuDNN's); bf16 output 1 bf16 ulp of the output magnitude (one float32 value
rounded once, on either side of a rounding boundary after a last-bit
difference).

K4 (pool adjoint) repeats its plain versions' compares and one division:
exact. K5 and K7 sum the same products in another order than autograd
through the plain forward, and K5's volume gradient is summed with atomics in
an order that changes from run to run: float32 atol/rtol 1e-5; with a bf16
payload the plain version scatters in bf16 while K5 sums in float32 and
rounds once, so they agree within a few bf16 ulp of the largest gradient.
K6: hard labels exact; soft 1e-6 (the plain version's ``scatter_add`` uses
atomics on the card).

The fused squaring step (``self_warp_add_batch``, a second entry of K2 and of
K5): the forward repeats the cast, the warp, the cast back and the add bit for
bit: exact. Its backward against autograd of the plain version: float32
payload 1e-5 of the largest gradient (another summation order, atomics); bf16
payload 4 bf16 ulp of the largest gradient (the plain version rounds every
contribution to bf16 and scatters in bf16), and 2 bf16 ulp against the
backward's formula summed in float64 (``self_warp_add_grad_float64``), which
has the kernel's two roundings and no other. On the +-40 field and the
constant shift many contributions meet in the border voxels and the plain
bf16 scatter drifts: there the kernel may differ from it by 4 ulp plus the
plain version's own gap to the float64 formula."""

import pytest
import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops import conv_pool as tcp
from multimodal_registration_torch.ops import pool as tpool
from multimodal_registration_torch.ops import warp as tw
from multimodal_registration_torch.ops.integrate import integrate_svf_batch

from _torch_port import bf16_ulp, cuda_device, rand, t  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [64, 12, 3])
def test_k1_conv3_lrelu_pool_matches_plain(cuda_device, dtype, cout):
    x = t(rand((2, 18, 12, 36, 2), 10), dtype).to(cuda_device)
    w = t(rand((cout, 2, 3, 3, 3), 11, 0.2)).to(cuda_device)
    b = t(rand((cout,), 12)).to(cuda_device)
    before = kernels.CONV3_LRELU_POOL.launches
    got = tcp.conv3_lrelu_pool(x, w, b)
    want = tcp.conv3_lrelu_pool(x, w, b, impl="plain")
    torch.cuda.synchronize()
    assert kernels.CONV3_LRELU_POOL.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, 9, 6, 18, cout)
    tol = 1e-5 if dtype == torch.float32 else bf16_ulp(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_k2_warp_matches_plain(cuda_device, dtype, interp):
    vol = t(rand((2, 20, 18, 22, 3), 10), dtype).to(cuda_device)
    flow = t(rand((2, 20, 18, 22, 3), 11, low=-30.0, high=30.0)).to(cuda_device)
    before = kernels.WARP_TRILINEAR.launches
    got = tw.warp_batch(vol, flow, interp=interp)
    want = tw.warp_batch(vol, flow, interp=interp, impl="plain")
    torch.cuda.synchronize()
    assert kernels.WARP_TRILINEAR.launches == before + 1
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_k2_nearest_half_voxel_ties_round_half_to_even(cuda_device):
    vol = t(rand((1, 9, 8, 10, 2), 13)).to(cuda_device)
    flow = torch.full((1, 9, 8, 10, 3), 0.5, device=cuda_device)
    got = tw.warp_batch(vol, flow, interp="nearest")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tw.warp_batch(vol, flow, interp="nearest", impl="plain"),
                               atol=0, rtol=0)
    # 2 + 0.5 rounds to 2 (half to even); roundf would give 3
    assert torch.equal(got[0, 2, 2, 2], vol[0, 2, 2, 2])


def test_k2_sample_absolute_coords_matches_plain(cuda_device):
    vol = t(rand((12, 10, 14), 14)).to(cuda_device)
    coords = t(rand((7, 9, 3), 15, low=-3.0, high=16.0)).to(cuda_device)
    got = tw.sample(vol, coords)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tw.sample(vol, coords, impl="plain"), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_warp_up2x_matches_plain(cuda_device, dtype):
    vol = t(rand((2, 32, 24, 40, 1), 12), dtype).to(cuda_device)
    fh = t(rand((2, 16, 12, 20, 3), 13, low=-3.0, high=3.0)).to(cuda_device)
    before = kernels.WARP_UP2X.launches
    got = tw.warp_up2x_batch(vol, fh)
    want = tw.warp_up2x_batch(vol, fh, impl="plain")
    torch.cuda.synchronize()
    assert kernels.WARP_UP2X.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else bf16_ulp(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    vol = torch.zeros((1, 8, 8, 8, 1), dtype=torch.float16, device=cuda_device)
    flow = torch.zeros((1, 8, 8, 8, 3), device=cuda_device)
    with pytest.raises(TypeError):
        tw.warp_batch(vol, flow)
    with pytest.raises(ValueError):  # volume on the card, field on the CPU
        tw.warp_batch(vol.float(), flow.cpu())
    w = torch.zeros((4, 1, 3, 3, 3), device=cuda_device)
    with pytest.raises(TypeError):
        tcp.conv3_lrelu_pool(vol, w, torch.zeros(4, device=cuda_device))


def _tied(shape, seed, dtype, device):
    """Values on a coarse grid, so that windows hold many exact ties."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return t(rng.integers(-3, 4, size=shape) * 0.5, dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tie", ["equal", "first"])
def test_k4_pool_bwd_matches_plain_with_ties(cuda_device, dtype, tie):
    x = _tied((2, 9, 12, 10, 5), 20, dtype, cuda_device)  # odd X: crop and pad
    g = t(rand((2, 4, 6, 5, 5), 21), dtype).to(cuda_device)
    before = kernels.MAX_POOL_2X_BWD.launches
    got = tpool.max_pool_2x_bwd(x, g, tie)
    want = tpool.max_pool_2x_bwd(x, g, tie, impl="plain")
    torch.cuda.synchronize()
    assert kernels.MAX_POOL_2X_BWD.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert float(got[:, 8].abs().max()) == 0.0  # the dropped plane gets no gradient


def test_k4_through_autograd(cuda_device):
    x = _tied((1, 8, 8, 8, 3), 22, torch.float32, cuda_device).requires_grad_()
    before = kernels.MAX_POOL_2X_BWD.launches
    tpool.max_pool_2x(x, tie="first").square().sum().backward()
    assert kernels.MAX_POOL_2X_BWD.launches == before + 1
    xp = x.detach().clone().requires_grad_()
    tpool.max_pool_2x(xp, tie="first", impl="plain").square().sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, atol=0, rtol=0)


def _grads(fn, *inputs):
    leaves = [i.detach().clone().requires_grad_() for i in inputs]
    out = fn(*leaves)
    w = torch.linspace(0.5, 1.5, out.numel(), device=out.device).reshape(out.shape)
    (out.float() * w).sum().backward()
    return [l.grad for l in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_warp_backward_matches_plain(cuda_device, dtype):
    vol = t(rand((2, 12, 10, 14, 3), 30), dtype).to(cuda_device)
    flow = t(rand((2, 12, 10, 14, 3), 31, low=-6.0, high=6.0)).to(cuda_device)
    before = kernels.WARP_TRILINEAR_BWD.launches
    gv, gf = _grads(lambda v, f: tw.warp_batch(v, f), vol, flow)
    torch.cuda.synchronize()
    assert kernels.WARP_TRILINEAR_BWD.launches == before + 1
    pv, pf = _grads(lambda v, f: tw.warp_batch(v, f, impl="plain"), vol, flow)
    assert gv.dtype == dtype and gf.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(gv, pv, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(gf, pf, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(gv.float(), pv.float(), rtol=0,
                                   atol=4 * bf16_ulp(pv.float().abs().max()))
        torch.testing.assert_close(gf, pf, atol=1e-4, rtol=1e-4)


def test_k5_zero_flow_clip_gradient_is_one_half_on_the_bound(cuda_device):
    vol = t(rand((1, 6, 6, 6, 1), 32)).to(cuda_device)
    flow = torch.zeros((1, 6, 6, 6, 3), device=cuda_device)
    (gf,) = _grads(lambda f: tw.warp_batch(vol, f), flow)
    (pf,) = _grads(lambda f: tw.warp_batch(vol, f, impl="plain"), flow)
    torch.testing.assert_close(gf, pf, atol=1e-6, rtol=1e-6)
    # at x = 0 the coordinate sits on the lower bound: half of (v[1] - v[0])
    w = torch.linspace(0.5, 1.5, vol.numel(), device=cuda_device).reshape(vol.shape)
    want = 0.5 * (vol[0, 1, 2, 2, 0] - vol[0, 0, 2, 2, 0]) * w[0, 0, 2, 2, 0]
    torch.testing.assert_close(gf[0, 0, 2, 2, 0], want, atol=1e-6, rtol=1e-6)


def test_k5_flow_only_and_nearest(cuda_device):
    vol = t(rand((1, 8, 8, 8, 2), 33)).to(cuda_device)
    flow = t(rand((1, 8, 8, 8, 3), 34, low=-2.0, high=2.0)).to(cuda_device)
    (gf,) = _grads(lambda f: tw.warp_batch(vol, f), flow)          # volume needs none
    (pf,) = _grads(lambda f: tw.warp_batch(vol, f, impl="plain"), flow)
    torch.testing.assert_close(gf, pf, atol=1e-5, rtol=1e-5)
    (gv,) = _grads(lambda v: tw.warp_batch(v, flow, interp="nearest"), vol)
    (pv,) = _grads(lambda v: tw.warp_batch(v, flow, interp="nearest", impl="plain"), vol)
    torch.testing.assert_close(gv, pv, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("payload", [None, torch.bfloat16])
def test_f4_integration_is_differentiable_on_the_card(cuda_device, payload):
    vel = t(rand((1, 12, 12, 12, 3), 35, 1.5)).to(cuda_device)
    (gk,) = _grads(lambda v: integrate_svf_batch(v, 4, payload), vel)
    (gp,) = _grads(lambda v: integrate_svf_batch(v, 4, payload, impl="plain"), vel)
    assert gk is not None and float(gk.abs().max()) > 0
    tol = 1e-4 if payload is None else 0.05 * float(gp.abs().max())
    torch.testing.assert_close(gk, gp, atol=tol, rtol=1e-4)


def test_f4_inference_kernels_raise_when_asked_for_a_gradient(cuda_device):
    x = torch.zeros((1, 8, 8, 8, 2), device=cuda_device)
    w = torch.zeros((4, 2, 3, 3, 3), device=cuda_device, requires_grad=True)
    b = torch.zeros(4, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K1"):
        tcp.conv3_lrelu_pool(x, w, b)
    with torch.no_grad():
        assert tcp.conv3_lrelu_pool(x, w, b).shape == (1, 4, 4, 4, 4)
    vol = torch.zeros((1, 8, 8, 8, 1), device=cuda_device)
    fh = torch.zeros((1, 4, 4, 4, 3), device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K3"):
        tw.warp_up2x_batch(vol, fh)
    assert tw.warp_up2x_batch(vol, fh.detach()).shape == vol.shape


@pytest.mark.parametrize("ldtype", [torch.uint8, torch.int32])
def test_k6_k7_warp_labels_match_plain(cuda_device, ldtype):
    import numpy as np

    L = 7
    labels = torch.as_tensor(np.random.default_rng(40).integers(0, L, (2, 11, 9, 13)),
                             dtype=ldtype, device=cuda_device)
    flow = t(rand((2, 11, 9, 13, 3), 41, low=-5.0, high=5.0)).to(cuda_device)
    b6, b7 = kernels.WARP_LABELS.launches, kernels.WARP_LABELS_BWD.launches
    soft, hard = tw.warp_labels_soft_hard_batch(labels, flow, L)
    psoft, phard = tw.warp_labels_soft_hard_batch(labels, flow, L, impl="plain")
    torch.cuda.synchronize()
    assert hard.dtype == torch.int32 and torch.equal(hard, phard)
    torch.testing.assert_close(soft, psoft, atol=1e-6, rtol=0)
    torch.testing.assert_close(soft.sum(-1), torch.ones_like(soft[..., 0]), atol=1e-5, rtol=0)
    (gk,) = _grads(lambda f: tw.warp_onehot_batch(labels, f, L), flow)
    (gp,) = _grads(lambda f: tw.warp_onehot_batch(labels, f, L, impl="plain"), flow)
    torch.cuda.synchronize()
    assert kernels.WARP_LABELS.launches == b6 + 2
    assert kernels.WARP_LABELS_BWD.launches == b7 + 1
    torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-5)


def test_k6_hard_labels_round_half_to_even(cuda_device):
    import numpy as np

    labels = torch.as_tensor(np.random.default_rng(42).integers(0, 5, (1, 9, 8, 10)),
                             dtype=torch.uint8, device=cuda_device)
    flow = torch.full((1, 9, 8, 10, 3), 0.5, device=cuda_device)
    soft, hard = tw.warp_labels_soft_hard_batch(labels, flow, 5)
    _, phard = tw.warp_labels_soft_hard_batch(labels, flow, 5, impl="plain")
    assert torch.equal(hard, phard)
    assert int(hard[0, 2, 2, 2]) == int(labels[0, 2, 2, 2])  # 2.5 rounds to 2
    assert int(hard[0, 1, 1, 1]) == int(labels[0, 2, 2, 2])  # 1.5 rounds to 2


def _fused_fields(device):
    """Fields for the fused step: name -> (B, X, Y, Z, 3) float32 on the card."""
    return {
        "smooth": t(rand((1, 24, 20, 32, 3), 50, 0.8)).to(device),
        "pm40": t(rand((1, 24, 20, 32, 3), 51, low=-40.0, high=40.0)).to(device),
        "shift10": torch.full((1, 24, 20, 32, 3), 10.0, device=device),
        "batch2": t(rand((2, 16, 16, 16, 3), 52, 1.5)).to(device),
        "indivisible": t(rand((1, 13, 9, 18, 3), 53, 2.0)).to(device),  # Z % 4 != 0: scalar path
        "indivisible_z4": t(rand((2, 11, 7, 20, 3), 54, 2.0)).to(device),
    }


FIELDS = ["smooth", "pm40", "shift10", "batch2", "indivisible", "indivisible_z4"]


@pytest.mark.parametrize("payload", [None, torch.bfloat16])
@pytest.mark.parametrize("field", FIELDS)
def test_fused_step_forward_is_exact(cuda_device, payload, field):
    phi = _fused_fields(cuda_device)[field]
    before = kernels.WARP_TRILINEAR.launches
    got = tw.self_warp_add_batch(phi, payload)
    torch.cuda.synchronize()
    assert kernels.WARP_TRILINEAR.launches == before + 1
    assert got.dtype == torch.float32 and got.data_ptr() != phi.data_ptr()
    torch.testing.assert_close(got, tw.self_warp_add_batch(phi, payload, impl="plain"),
                               atol=0, rtol=0)


def _fused_cotangent(phi):
    return torch.linspace(-1.0, 1.5, phi.numel(), device=phi.device).reshape(phi.shape)


def _fused_grad(phi, payload, impl=None):
    leaf = phi.detach().clone().requires_grad_()
    tw.self_warp_add_batch(leaf, payload, impl=impl).backward(_fused_cotangent(phi))
    return leaf.grad


@pytest.mark.parametrize("payload", [None, torch.bfloat16])
@pytest.mark.parametrize("field", FIELDS)
def test_fused_step_backward_matches_plain(cuda_device, payload, field):
    phi = _fused_fields(cuda_device)[field]
    before = kernels.WARP_TRILINEAR_BWD.launches
    got = _fused_grad(phi, payload)
    torch.cuda.synchronize()
    assert kernels.WARP_TRILINEAR_BWD.launches == before + 1  # kernel B is not counted
    want = _fused_grad(phi, payload, impl="plain")
    m = float(want.abs().max())
    if payload is None:
        torch.testing.assert_close(got, want, atol=1e-5 * max(m, 1.0), rtol=0)
        return
    exact = tw.self_warp_add_grad_float64(phi, _fused_cotangent(phi), payload)
    torch.testing.assert_close(got, exact, atol=2 * bf16_ulp(m), rtol=0)
    gap_plain = float((want - exact).abs().max()) if field in ("pm40", "shift10") else 0.0
    torch.testing.assert_close(got, want, atol=4 * bf16_ulp(m) + gap_plain, rtol=0)


def test_fused_step_zero_field_gradient(cuda_device):
    phi = torch.zeros((1, 6, 6, 8, 3), device=cuda_device)
    torch.testing.assert_close(_fused_grad(phi, None), _fused_grad(phi, None, impl="plain"),
                               atol=1e-6, rtol=0)
    # x-displacement zero on the border planes, the rest random: one half of the
    # slope on the lower bound, none on the far bound
    phi = t(rand((1, 6, 6, 8, 3), 55, 1.0)).to(cuda_device)
    phi[0, 0, :, :, 0] = 0.0
    phi[0, -1, :, :, 0] = 0.0
    torch.testing.assert_close(_fused_grad(phi, None), _fused_grad(phi, None, impl="plain"),
                               atol=1e-5, rtol=1e-5)


def test_scratch_is_zero_after_a_backward_and_a_second_backward_agrees(cuda_device):
    phi = _fused_fields(cuda_device)["smooth"]
    first = _fused_grad(phi, torch.bfloat16)
    torch.cuda.synchronize()
    buffers = tw.scratch_buffers()
    assert buffers and all(float(b.abs().max()) == 0.0 for b in buffers)
    second = _fused_grad(phi, torch.bfloat16)
    torch.cuda.synchronize()
    assert all(float(b.abs().max()) == 0.0 for b in tw.scratch_buffers())
    # the same sums through atomics in another order: last bits of float32,
    # at most one bf16 rounding flipped
    torch.testing.assert_close(first, second, rtol=0,
                               atol=bf16_ulp(float(first.abs().max())))
    # the general backward shares the mechanism
    vol = t(rand((1, 12, 10, 16, 2), 56), torch.bfloat16).to(cuda_device)
    flow = t(rand((1, 12, 10, 16, 3), 57, 2.0)).to(cuda_device)
    _grads(lambda v, f: tw.warp_batch(v, f), vol, flow)
    torch.cuda.synchronize()
    assert all(float(b.abs().max()) == 0.0 for b in tw.scratch_buffers())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 2, 4, 5])
def test_general_backward_for_other_channel_counts(cuda_device, dtype, channels):
    """C != 3 goes through the general kernel: its tiled scatter up to four
    channels, one atomic per contribution beyond."""
    vol = t(rand((2, 13, 10, 16, channels), 58), dtype).to(cuda_device)
    flow = t(rand((2, 13, 10, 16, 3), 59, low=-5.0, high=5.0)).to(cuda_device)
    gv, gf = _grads(lambda v, f: tw.warp_batch(v, f), vol, flow)
    pv, pf = _grads(lambda v, f: tw.warp_batch(v, f, impl="plain"), vol, flow)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(gv, pv, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(gf, pf, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(gv.float(), pv.float(), rtol=0,
                                   atol=4 * bf16_ulp(pv.float().abs().max()))
        torch.testing.assert_close(gf, pf, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("grid", [(16, 12, 20), (8, 6, 10)])
def test_general_backward_tiled_and_untiled_agree_with_plain(cuda_device, grid):
    """A field on the volume's own grid takes the tiled scatter, a field on
    another grid the kernel with one atomic per contribution."""
    vol = t(rand((1, 16, 12, 20, 3), 60)).to(cuda_device)
    flow = t(rand((1, *grid, 3), 61, low=-30.0, high=30.0)).to(cuda_device)
    gv, gf = _grads(lambda v, f: tw.warp_batch(v, f), vol, flow)
    pv, pf = _grads(lambda v, f: tw.warp_batch(v, f, impl="plain"), vol, flow)
    torch.testing.assert_close(gv, pv, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gf, pf, atol=1e-5, rtol=1e-5)


def test_integration_through_the_fused_steps_is_exact_and_counts_one_launch_a_step(cuda_device):
    vel = t(rand((2, 16, 12, 20, 3), 62, 2.0)).to(cuda_device)
    for payload in (None, torch.bfloat16):
        before = kernels.WARP_TRILINEAR.launches
        got = integrate_svf_batch(vel, 5, payload)
        torch.cuda.synchronize()
        assert kernels.WARP_TRILINEAR.launches == before + 5
        torch.testing.assert_close(got, integrate_svf_batch(vel, 5, payload, impl="plain"),
                                   atol=0, rtol=0)


def test_fused_step_refuses_what_the_kernel_does_not_take(cuda_device):
    phi = torch.zeros((1, 8, 8, 8, 3), device=cuda_device)
    with pytest.raises(TypeError):
        tw.self_warp_add_batch(phi, torch.float16)
    with pytest.raises(TypeError):
        tw.self_warp_add_batch(phi.double())
