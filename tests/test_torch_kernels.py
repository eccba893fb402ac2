"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Without a card every test here skips: a CUDA kernel has no CPU mode.
This file imports nothing of JAX, so the machine with the card (which has no
JAX) runs it on its own:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

Tolerances: K2 and K3 repeat their plain versions' float32 operations in the
same order without FMA contraction, so they match exactly (K3: 1e-5 for the
upsample's sums). K1: float32 (the float32 units) atol 1e-5 (a 54-term sum in
another order than cuDNN's); bf16 (an implicit GEMM on the tensor cores) 1
bf16 ulp of the output magnitude (one float32 value rounded once, on either
side of a rounding boundary after a last-bit difference).

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
plain version's own gap to the float64 formula.

K8 (the int8 conv) sums integers and repeats its plain version's float32
quantization and epilogue one rounding at a time: its int32 sums and its
outputs are equal to the plain version's, bit for bit, also at shapes that
its boxes of 2 x 4 x 16 voxels do not divide (an idle block in the last
cluster, batch 4 with X 1, two blocks of output channels); one wgmma of its
layout equals the host product of the same int8 values. F5: a float32 model
on the card with the caller's TF32 switched on agrees with the same model on
the CPU within 1e-5 of the largest value (float32 sums in another order;
TF32 would be about 1e-3)."""

import pytest
import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops import conv_int8 as tci
from multimodal_registration_torch.ops import conv_pool as tcp
from multimodal_registration_torch.ops import pool as tpool
from multimodal_registration_torch.ops import warp as tw
from multimodal_registration_torch.ops.integrate import integrate_svf_batch

from _torch_port import bf16_ulp, cuda_device, rand, t  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [64, 12, 3, 256])
@pytest.mark.parametrize("cin", [2, 1, 3, 4])
def test_k1_conv3_lrelu_pool_matches_plain(cuda_device, dtype, cout, cin):
    """bf16 on the tensor cores, float32 on the float32 units; batch 2 and a
    shape that no tile of either kernel divides."""
    x = t(rand((2, 18, 12, 36, cin), 10), dtype).to(cuda_device)
    w = t(rand((cout, cin, 3, 3, 3), 11, 0.2)).to(cuda_device)
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
def test_k1_wide_input_takes_the_general_loop_over_k(cuda_device, dtype):
    """Cin > 2: more k-steps than the tensor-core kernel unrolls."""
    x = t(rand((1, 10, 12, 20, 6), 18), dtype).to(cuda_device)
    w = t(rand((24, 6, 3, 3, 3), 19, 0.2)).to(cuda_device)
    b = t(rand((24,), 20)).to(cuda_device)
    got = tcp.conv3_lrelu_pool(x, w, b)
    want = tcp.conv3_lrelu_pool(x, w, b, impl="plain")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else bf16_ulp(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 2, 2), (6, 4, 10), (10, 18, 18), (8, 16, 34)])
def test_k1_constant_one_input_shows_the_zero_padding(cuda_device, dtype, shape):
    """With x == 1 an output is the sum of the weights at the taps inside the
    volume: every face, edge and corner of the SAME padding shows, at volumes
    smaller than a tile, equal to one and one voxel more."""
    x = torch.ones((1, *shape, 2), dtype=dtype, device=cuda_device)
    w = t(rand((16, 2, 3, 3, 3), 13, 0.5)).to(cuda_device)
    b = t(rand((16,), 14)).to(cuda_device)
    got = tcp.conv3_lrelu_pool(x, w, b)
    want = tcp.conv3_lrelu_pool(x, w, b, impl="plain")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else bf16_ulp(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_k1_float32_takes_a_negative_slope(cuda_device):
    """The float32 kernel applies the LeakyReLU before the max, so a slope
    that reorders values is served; only the bfloat16 kernel refuses it."""
    x = t(rand((1, 6, 8, 10, 2), 21)).to(cuda_device)
    w = t(rand((8, 2, 3, 3, 3), 22, 0.2)).to(cuda_device)
    b = t(rand((8,), 23)).to(cuda_device)
    got = tcp.conv3_lrelu_pool(x, w, b, neg_slope=-0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tcp.conv3_lrelu_pool(x, w, b, neg_slope=-0.5, impl="plain"),
                               atol=1e-5, rtol=0)


def test_k1_prepares_its_weights_once_per_version(cuda_device):
    x = t(rand((1, 8, 8, 16, 2), 15), torch.bfloat16).to(cuda_device)
    w = t(rand((8, 2, 3, 3, 3), 16, 0.2)).to(cuda_device)
    b = t(rand((8,), 17)).to(cuda_device)
    first = tcp.conv3_lrelu_pool(x, w, b)
    cached = tcp.prepared_weights(w, b, torch.bfloat16)[0]
    assert cached is tcp.prepared_weights(w, b, torch.bfloat16)[0]
    with torch.cuda.stream(torch.cuda.Stream(cuda_device)):  # prepared anew for another stream
        assert tcp.prepared_weights(w, b, torch.bfloat16)[0] is not cached
    with torch.no_grad():
        w.mul_(-1.5)  # an in-place update: the next call must see the new weights
    second = tcp.conv3_lrelu_pool(x, w, b)
    want = tcp.conv3_lrelu_pool(x, w, b, impl="plain")
    torch.cuda.synchronize()
    assert not torch.equal(first, second)
    torch.testing.assert_close(second.float(), want.float(), rtol=0,
                               atol=bf16_ulp(want.float().abs().max()))
    view = x.reshape(-1)[2:2 + 8 * 8 * 8 * 2].reshape(1, 8, 8, 8, 2)  # 4 bytes off a 16-byte line
    torch.testing.assert_close(tcp.conv3_lrelu_pool(view, w, b).float(),
                               tcp.conv3_lrelu_pool(view, w, b, impl="plain").float(), rtol=0,
                               atol=bf16_ulp(want.float().abs().max()))


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
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("case", ["smooth", "pm40", "far_edge", "indivisible"])
def test_k3_warp_up2x_matches_plain(cuda_device, dtype, channels, case):
    """Fields within +-3 voxels, far beyond the border (+-40: every corner
    clamps somewhere), pushing every voxel onto the far edge, and a volume
    that no block of cells divides."""
    shape = (2, 14, 10, 22) if case == "indivisible" else (2, 32, 24, 40)
    half = (shape[0], *(s // 2 for s in shape[1:]), 3)
    vol = t(rand((*shape, channels), 12), dtype).to(cuda_device)
    if case == "far_edge":
        fh = torch.full(half, 25.0, device=cuda_device)
    else:
        amp = 40.0 if case == "pm40" else 3.0
        fh = t(rand(half, 13, low=-amp, high=amp)).to(cuda_device)
    before = kernels.WARP_UP2X.launches
    got = tw.warp_up2x_batch(vol, fh)
    want = tw.warp_up2x_batch(vol, fh, impl="plain")
    torch.cuda.synchronize()
    assert kernels.WARP_UP2X.launches == before + 1
    assert got.shape == vol.shape and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else bf16_ulp(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    if case == "far_edge":  # x + 50 clamps to the last voxel on every axis
        assert torch.equal(got[0, 3, 3, 3], vol[0, -1, -1, -1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    vol = torch.zeros((1, 8, 8, 8, 1), dtype=torch.float16, device=cuda_device)
    flow = torch.zeros((1, 8, 8, 8, 3), device=cuda_device)
    with pytest.raises(TypeError):
        tw.warp_batch(vol, flow)
    with pytest.raises(ValueError):  # volume on the card, field on the CPU
        tw.warp_batch(vol.float(), flow.cpu())
    w = torch.zeros((4, 1, 3, 3, 3), device=cuda_device)
    b = torch.zeros(4, device=cuda_device)
    with pytest.raises(TypeError):  # float16 input
        tcp.conv3_lrelu_pool(vol, w, b)
    with pytest.raises(ValueError):  # the tensor-core kernel pools before the LeakyReLU
        tcp.conv3_lrelu_pool(vol.bfloat16(), w, b, neg_slope=-0.1)
    with pytest.raises(ValueError):  # weights on the CPU
        tcp.conv3_lrelu_pool(vol.float(), w.cpu(), b)
    with pytest.raises(ValueError):  # more shared memory than a block may use
        tcp.conv3_lrelu_pool(torch.zeros((1, 4, 4, 4, 64), device=cuda_device),
                             torch.zeros((64, 64, 3, 3, 3), device=cuda_device),
                             torch.zeros(64, device=cuda_device))
    with pytest.raises(ValueError):
        tcp.conv3_lrelu_pool(torch.zeros((1, 4, 4, 4, 64), dtype=torch.bfloat16,
                                         device=cuda_device),
                             torch.zeros((256, 64, 3, 3, 3), device=cuda_device),
                             torch.zeros(256, device=cuda_device))


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


# ---- inference on real-scan layouts: two models, tile batches, the spline ----

def _registrar(seed, impl=None, svf_smooth_sigma=None, max_batch=4):
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import Registrar, vxm_config_from
    from multimodal_registration_torch.models.vxm_dense import VxmDense

    cfg = InferenceConfig.from_dict(dict(enc=[16] * 4, dec=[16] * 6, compute_dtype="bfloat16"))
    torch.manual_seed(seed)
    params = VxmDense(vxm_config_from(cfg), device="cpu").state_dict()
    # a flow head that gives a field of about a voxel
    params["flow.weight"] = 0.5 * torch.randn(params["flow.weight"].shape,
                                              generator=torch.Generator().manual_seed(seed))
    return Registrar(cfg, params, max_batch=max_batch, device="cuda", impl=impl,
                     svf_smooth_sigma=svf_smooth_sigma)


def _pair(batch, shape=(32, 32, 48), seed=30):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((batch, *shape), generator=g), torch.rand((batch, *shape), generator=g)


def test_two_registrars_serve_their_own_weights(cuda_device):
    """Two models in one process (the cascade's): K1's prepared weights are
    cached per parameter version and stream, so neither serves the other's.
    Each registrar's kernel path holds against its own plain path and repeats
    itself exactly after the other one ran; the first has the cascade's
    smoothing override."""
    mov, fx = _pair(1)
    regs = {"model1": _registrar(1, svf_smooth_sigma=3.0), "model2": _registrar(2)}
    plain = {"model1": _registrar(1, "plain", svf_smooth_sigma=3.0), "model2": _registrar(2, "plain")}
    first = {k: r.predict_tensors(mov, fx) for k, r in regs.items()}
    again = {k: r.predict_tensors(mov, fx) for k, r in reversed(list(regs.items()))}
    for k in regs:
        pm, pw = plain[k].predict_tensors(mov, fx)
        (km, kw), (am, aw) = first[k], again[k]
        assert torch.equal(kw, aw) and torch.equal(km, am), k
        assert float((kw - pw).abs().max()) <= 0.1 and float((km - pm).abs().max()) <= 0.05, k
    assert float((first["model1"][1] - first["model2"][1]).abs().max()) > 0.1
    assert regs["model1"].vxm_cfg.svf_smooth_sigma == 3.0


def test_tile_batches_through_the_kernels(cuda_device):
    """Tiles in chunks of ``max_batch`` 4, the last chunk padded: K1, K2 and
    K3 at batch 4 against their plain versions, one K1 and K3 launch per
    chunk."""
    mov, fx = _pair(6, (32, 32, 32), seed=31)
    kernels.reset_launch_counts()
    km, kw = _registrar(3).predict_tensors(mov, fx)
    counts = kernels.launch_counts()
    assert counts["conv3_lrelu_pool"] == 2 and counts["warp_up2x"] == 2, counts
    assert counts["warp_trilinear"] == 10, counts
    pm, pw = _registrar(3, "plain").predict_tensors(mov, fx)
    assert km.shape == (6, 32, 32, 32) and kw.shape == (6, 16, 16, 16, 3)
    assert float((kw - pw).abs().max()) <= 0.1 and float((km - pm).abs().max()) <= 0.05


@pytest.mark.parametrize("kind", ["separable", "oblique"])
@pytest.mark.parametrize("mode", ["constant", "nearest"])
def test_device_spline_on_the_card(cuda_device, kind, mode):
    """The device spline on the card against the same on the CPU (1e-5 of
    max|vol|) and scipy in float64 (1e-4), with TF32 switched on by the
    caller: the operator products must still run in full float32."""
    import numpy as np
    from scipy.ndimage import affine_transform

    from multimodal_registration_torch.ops.resample import device_spline_resample

    c, s = np.cos(0.1), np.sin(0.1)
    M = (np.array([[0.0, 1.25, 0.0, -0.5], [0.8, 0.0, 0.0, 1.0], [0.0, 0.0, 1.1, 0.3],
                   [0, 0, 0, 1.0]]) if kind == "separable" else
         np.array([[c, -s, 0.0, 1.5], [s, c, 0.0, -2.0], [0.0, 0.0, 0.9, 0.4], [0, 0, 0, 1.0]]))
    vol = rand((40, 36, 28, 4), 32)
    out_shape = (44, 30, 30)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = device_spline_resample(t(vol).cuda(), M, out_shape, mode, 0.7, 3).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    cpu = device_spline_resample(t(vol), M, out_shape, mode, 0.7, 3).numpy()
    ref = np.stack([affine_transform(vol[..., k].astype(np.float64), M[:3, :3], offset=M[:3, 3],
                                     output_shape=out_shape, order=3, mode=mode, cval=0.7)
                    for k in range(4)], -1)
    m = float(np.abs(vol).max())
    assert np.abs(got - cpu).max() <= 1e-5 * m
    assert np.abs(got - ref).max() <= 1e-4 * m


def test_blend_on_the_card(cuda_device):
    from multimodal_registration_torch.infer.blend import blend_subvol_fields

    coords = [(0, 16, 0, 16, 0, 16), (8, 24, 0, 16, 4, 20), (16, 32, 8, 24, 8, 24)]
    warps = rand((3, 16, 16, 16, 3), 33)
    got = blend_subvol_fields((16, 16, 16), (32, 24, 24), coords, t(warps).cuda())
    want = blend_subvol_fields((16, 16, 16), (32, 24, 24), coords, t(warps))
    assert float((got.cpu() - want).abs().max()) <= 1e-6


def test_float32_products_ignore_the_callers_tf32(cuda_device):
    """Fault F3 for matrix products: with the caller's TF32 switched on, the
    sample coordinates of a linear resample (K2) and the interpolation
    products of ``resize`` still run in full float32 and agree with the CPU."""
    import numpy as np

    from multimodal_registration_torch.ops.resample import affine_resample
    from multimodal_registration_torch.ops.resize import resize

    c, s = np.cos(0.3), np.sin(0.3)
    M = np.array([[1.2 * c, -s, 0.0, 3.0], [1.2 * s, c, 0.0, -2.0], [0.0, 0.0, 0.8, 1.5],
                  [0.0, 0.0, 0.0, 1.0]])
    vol = rand((140, 120, 90), 34, low=0.0, high=1.0)
    small = t(rand((20, 18, 16, 3), 35))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = affine_resample(vol, M, np.eye(4), (150, 130, 100), "linear", device="cuda")
        gr = resize(small.cuda(), (3.5, 2.5, 1.5)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    want = affine_resample(vol, M, np.eye(4), (150, 130, 100), "linear", device="cpu")
    assert np.abs(got - want).max() <= 1e-5
    torch.testing.assert_close(gr, resize(small, (3.5, 2.5, 1.5)), atol=1e-6, rtol=0)


# ---- K8: the int8 conv of the published widths, and fault F5 ---------------

def _k8_inputs(shape, cin, cout, dtype, seed, device):
    x = t(rand((*shape, cin), seed), dtype).to(device)
    w = t(rand((cout, cin, 3, 3, 3), seed + 1, 0.05)).to(device)
    b = t(rand((cout,), seed + 2, 0.1)).to(device)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [256, 24, 3])
@pytest.mark.parametrize("cin,shape", [(64, (1, 9, 10, 11)), (72, (2, 5, 6, 7)),
                                       (256, (4, 6, 5, 3)), (512, (1, 7, 9, 6))])
def test_k8_conv3_int8_equals_plain(cuda_device, dtype, cout, cin, shape):
    """Sums and outputs bit for bit, at shapes that no tile of the kernel
    divides (M is not a multiple of 128, Cin not always of 64), batch 1-4."""
    x, w, b = _k8_inputs(shape, cin, cout, dtype, cin + cout, cuda_device)
    before = kernels.CONV3_INT8.launches
    got = tci.conv3_int8(x, w, b, 2.5)
    sums = tci.conv3_int8(x, w, b, 2.5, sums=True)
    torch.cuda.synchronize()
    assert kernels.CONV3_INT8.launches == before + 2
    assert got.dtype == dtype and got.shape == (*shape, cout) and sums.dtype == torch.int32
    assert torch.equal(sums, tci.conv3_int8(x, w, b, 2.5, impl="plain", sums=True))
    assert torch.equal(got, tci.conv3_int8(x, w, b, 2.5, impl="plain"))
    # and the plain version on the CPU (the JAX package's arithmetic)
    assert torch.equal(got.cpu(), tci.conv3_int8(x.cpu(), w.cpu(), b.cpu(), 2.5, impl="plain"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 4, 8, 24), 64, 256),   # Z 24: a full and a ragged z box
    ((1, 2, 4, 12), 72, 75),    # Z 12, a single box: the cluster's second block idle
    ((1, 5, 4, 11), 200, 3),    # Z 11, three boxes (odd): the last cluster's partner idle
    ((1, 5, 9, 13), 128, 24),   # nine boxes
    ((4, 1, 6, 20), 64, 75),    # batch 4 with X 1
    ((1, 3, 3, 17), 72, 256),   # Z 17: a z box of one voxel
    ((1, 4, 4, 16), 64, 300),   # two blocks of 256 output channels
])
def test_k8_tiling_edges_equal_plain(cuda_device, dtype, shape, cin, cout):
    """The wgmma kernel's boxes of 2 x 4 x 16 voxels at shapes that none
    divides: sums and outputs bit for bit, against the plain version on the
    card and on the CPU."""
    x, w, b = _k8_inputs(shape, cin, cout, dtype, 3 * cin + cout, cuda_device)
    before = kernels.CONV3_INT8.launches
    got = tci.conv3_int8(x, w, b, 2.0)
    sums = tci.conv3_int8(x, w, b, 2.0, sums=True)
    torch.cuda.synchronize()
    assert kernels.CONV3_INT8.launches == before + 2
    assert torch.equal(sums, tci.conv3_int8(x, w, b, 2.0, impl="plain", sums=True))
    assert torch.equal(got, tci.conv3_int8(x, w, b, 2.0, impl="plain"))
    assert torch.equal(sums.cpu(), tci.conv3_int8(x.cpu(), w.cpu(), b.cpu(), 2.0, impl="plain",
                                                  sums=True))
    assert torch.equal(got.cpu(), tci.conv3_int8(x.cpu(), w.cpu(), b.cpu(), 2.0, impl="plain"))


def test_k8_clusters_walk_many_tiles(cuda_device):
    """More tiles (300 pairs of boxes) than clusters on the card: each
    cluster of the persistent kernel walks several, and the next tile's loads
    overlap the last one's epilogue."""
    x, w, b = _k8_inputs((1, 40, 40, 48), 64, 256, torch.bfloat16, 44, cuda_device)
    assert tci.Int8ConvPlan(x.shape, 256).n_tiles == 300
    for s in (False, True):
        assert torch.equal(tci.conv3_int8(x, w, b, 2.0, sums=s),
                           tci.conv3_int8(x, w, b, 2.0, impl="plain", sums=s))


@pytest.mark.parametrize("kstep", [0, 1])
def test_k8_one_wgmma_equals_the_host_product(cuda_device, kstep):
    """One wgmma m64n256k32 s8 through the conv's descriptors (64-byte
    swizzle, the second k-step at +32 bytes) and fragment layout, from tiles
    that TMA staged, against the product of the same int8 values on the host."""
    g = torch.Generator().manual_seed(50 + kstep)
    a = torch.randint(-127, 128, (64, 64), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (256, 64), generator=g, dtype=torch.int8)
    ad, bd = a.to(cuda_device), b.to(cuda_device)
    out = torch.empty((64, 256), dtype=torch.int32, device=cuda_device)
    kernels.CONV3_INT8.launch_entry("wgmma_tile_launch", ad.data_ptr(), bd.data_ptr(),
                                    out.data_ptr(), kstep, kernels.stream_of(ad), count=False)
    torch.cuda.synchronize()
    k = slice(32 * kstep, 32 * kstep + 32)
    assert torch.equal(out.cpu(), (a[:, k].long() @ b[:, k].long().T).int())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_an_amax_that_clips(cuda_device, dtype):
    x, w, b = _k8_inputs((2, 8, 8, 8), 128, 64, dtype, 40, cuda_device)
    xq = tci.quantize_act(x, 0.5)
    assert int((xq.abs() == 127).sum()) > 0.1 * xq.numel()
    for s in (False, True):
        assert torch.equal(tci.conv3_int8(x, w, b, 0.5, sums=s),
                           tci.conv3_int8(x, w, b, 0.5, impl="plain", sums=s))


def test_k8_on_the_grid_equals_the_float32_block(cuda_device):
    """The JAX ``test_grid_exact`` rule on the card: integer inputs and
    weights on the int8 grid make the int8 block equal the float32 block."""
    from multimodal_registration_torch.models.unet import ConvBlock

    g = torch.Generator().manual_seed(41)
    x = torch.randint(-127, 128, (1, 6, 7, 9, 64), generator=g).float().cuda()
    k = torch.randint(-126, 127, (32, 64, 3, 3, 3), generator=g).float()
    k[:, 0, 0, 0, 0] = 127.0
    blocks = {q: ConvBlock(64, 32, torch.float32, "cuda", quant=q) for q in ("", "int8")}
    for blk in blocks.values():
        with torch.no_grad():
            blk.conv.weight.copy_(k)
            blk.conv.bias.copy_(torch.linspace(-1, 1, 32))
    blocks["int8"].amax = 127.0
    with torch.inference_mode():
        assert torch.equal(blocks[""](x), blocks["int8"](x))


def test_k8_refuses_grad_and_caches_its_weights(cuda_device):
    x, w, b = _k8_inputs((1, 6, 6, 6), 64, 16, torch.bfloat16, 42, cuda_device)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tci.conv3_int8(x, w.requires_grad_(), b, 1.0)
    w = w.detach()
    tci.conv3_int8(x, w, b, 1.0)
    n = len(tci._PREPARED)
    first = tci.conv3_int8(x, w, b, 1.0)
    assert len(tci._PREPARED) == n  # the same parameters and scale: prepared once
    with torch.no_grad():
        w.mul_(2.0)  # a new version of w
    second = tci.conv3_int8(x, w, b, 1.0)
    assert not torch.equal(first, second)
    assert torch.equal(second, tci.conv3_int8(x, w, b, 1.0, impl="plain"))


def test_f5_float32_model_ignores_the_callers_tf32(cuda_device):
    """Fault F5: with ``compute_dtype`` float32 every U-Net conv (K1's float32
    kernel, the cuDNN convs, the head) runs in full float32 although the
    caller switched cuDNN's TF32 on."""
    from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense

    cfg = VxmConfig(enc=(16,) * 4, dec=(16,) * 6, compute_dtype="float32",
                    integrate_payload_dtype="")
    torch.manual_seed(43)
    cpu = VxmDense(cfg, device="cpu").eval()
    with torch.no_grad():
        cpu.flow.weight.normal_(0.0, 1.0)  # a field of about a voxel
    card = VxmDense(cfg, device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    mov, fx = (torch.rand((1, 32, 32, 48, 1), generator=torch.Generator().manual_seed(s))
               for s in (44, 45))
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = card(mov.cuda(), fx.cuda())
    finally:
        torch.backends.cudnn.allow_tf32 = old
    with torch.inference_mode():
        want = cpu(mov, fx)
    for k in ("svf", "warp"):
        m = float(want[k].abs().max())
        assert m > 0.1, k
        assert float((got[k].cpu() - want[k]).abs().max()) <= 1e-5 * m, k
