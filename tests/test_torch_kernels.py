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
K6: hard labels exact; soft 1e-6 (both sum each voxel's corner weights one
at a time, in (dx, dy, dz) order).

The Dice entries of K6 and K7 (``warp_onehot_dice_batch``): the sums within
1e-5 relative of their plain version (which sums in float64), the flow
gradient within 1e-5 of its largest entry; the fused loss against the dense
composition likewise; the sums bit for bit run to run and whatever the batch.

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
TF32 would be about 1e-3).

K9 (the flow head's float32 conv C -> 3, forward and both gradients) sums
float32 products in another order than its plain versions, held in float64:
each element within 4 * sqrt(N) * 2**-24 of the root of the sum of its N
squared terms (``ops/flow_head.py::references_and_limits``), its bf16 input
gradient also 1 bf16 ulp (a rounding boundary); a weight gradient of the
cotangent rounded to bf16 lies far outside. It sums in a fixed order,
without atomics: two runs give the same bits."""

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


def test_k1_w256_first_level_at_192_cubed_batch_2(cuda_device):
    """F12: B * X * Y * Z * Cout = 3.6e9 here, but the bf16 kernel indexes a
    batch element's input (192^3 x 2 values) in 32 bits and the batch and the
    output in 64; the guard used to refuse this shape. The plain version's
    float32 activation is about 14.5 GB."""
    x = t(rand((2, 192, 192, 192, 2), 24), torch.bfloat16).to(cuda_device)
    w = t(rand((256, 2, 3, 3, 3), 25, 0.2)).to(cuda_device)
    b = t(rand((256,), 26)).to(cuda_device)
    before = kernels.CONV3_LRELU_POOL.launches
    got = tcp.conv3_lrelu_pool(x, w, b)
    want = tcp.conv3_lrelu_pool(x, w, b, impl="plain")
    torch.cuda.synchronize()
    assert kernels.CONV3_LRELU_POOL.launches == before + 1
    assert got.shape == (2, 96, 96, 96, 256)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=bf16_ulp(want.float().abs().max()))
    del want
    torch.cuda.empty_cache()


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


@pytest.mark.parametrize("tie", ["equal", "first"])
def test_k4_w256_enc0_pool_at_160x160x192(cuda_device, tie):
    """The w256 training step's first pool adjoint: 256 channels on the full
    160x160x192 grid (1.26e9 values), bf16, values drawn on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    x = (torch.randint(-3, 4, (1, 160, 160, 192, 256), generator=gen, device=cuda_device)
         * 0.5).bfloat16()
    g = torch.randn((1, 80, 80, 96, 256), generator=gen, device=cuda_device).bfloat16()
    before = kernels.MAX_POOL_2X_BWD.launches
    got = tpool.max_pool_2x_bwd(x, g, tie)
    want = tpool.max_pool_2x_bwd(x, g, tie, impl="plain")
    torch.cuda.synchronize()
    assert kernels.MAX_POOL_2X_BWD.launches == before + 1
    assert torch.equal(got, want)


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


def _dice_inputs(device, ldtype, L, shape=(2, 11, 9, 13), offset=True):
    """Source labels (int32 ones with a few outside [0, L)), a flow, and a
    soft target map whose data starts 4 bytes past a 16-byte boundary (with
    ``offset``), so the forward's staging takes its 4-byte head and tail."""
    import numpy as np

    rng = np.random.default_rng(60)
    lab = rng.integers(0, L, shape)
    if ldtype == torch.int32:
        lab.reshape(-1)[::97] = L  # no channel
        lab.reshape(-1)[5::89] = -1
    labels = torch.as_tensor(lab, dtype=ldtype, device=device)
    flow = t(rand((*shape, 3), 61, low=-5.0, high=5.0)).to(device)
    trg = torch.as_tensor(rng.integers(0, L, shape), dtype=torch.uint8, device=device)
    soft = tw.warp_onehot_batch(trg, t(rand((*shape, 3), 62, low=-1.0, high=1.0)).to(device), L)
    if offset:
        buf = torch.empty(soft.numel() + 1, device=device)
        buf[1:] = soft.reshape(-1)
        soft = buf[1:].view(soft.shape)
    return labels, flow, soft


@pytest.mark.parametrize("zeropad", [False, True])
@pytest.mark.parametrize("L", [7, 26, 100])
@pytest.mark.parametrize("ldtype", [torch.uint8, torch.int32])
def test_k6_k7_dice_entries_match_plain(cuda_device, ldtype, L, zeropad):
    """K6's Dice entry (the sums) within 1e-5 relative of its plain version
    (float64 sums; the kernel sums in float32 per thread and tile, in
    float64 across them), K7's (the flow gradient) within 1e-5 of the
    largest gradient; L = 100 takes tiles of 64 voxels."""
    labels, flow, map2 = _dice_inputs(cuda_device, ldtype, L)
    b6, b7 = kernels.WARP_LABELS.launches, kernels.WARP_LABELS_BWD.launches
    e6 = kernels.WARP_LABELS.entry_launches.get("warp_labels_dice_fwd_launch", 0)
    sums = tw.warp_labels_dice_sums(labels, flow, map2, L, zeropad)
    psums = tw.warp_labels_dice_sums(labels, flow, map2, L, zeropad, impl="plain")
    coef = t(rand((2, L, 2), 63)).to(cuda_device)
    g = tw.warp_labels_dice_flow_grad(labels, flow, map2, coef, L, zeropad)
    pg = tw.warp_labels_dice_flow_grad(labels, flow, map2, coef, L, zeropad, impl="plain")
    torch.cuda.synchronize()
    assert kernels.WARP_LABELS.launches == b6 + 1 and kernels.WARP_LABELS_BWD.launches == b7 + 1
    assert kernels.WARP_LABELS.entry_launches["warp_labels_dice_fwd_launch"] == e6 + 1
    torch.testing.assert_close(sums, psums, atol=1e-6, rtol=1e-5)
    m = float(pg.abs().max())
    assert m > 0.1
    torch.testing.assert_close(g, pg, atol=1e-5 * m, rtol=1e-5)


def test_k6_dice_entry_is_deterministic_and_batch_independent(cuda_device):
    """No atomics: the sums repeat bit for bit, and a batch element's sums do
    not depend on the batch around it (the blocks are a function of the
    volume and the label count)."""
    labels, flow, map2 = _dice_inputs(cuda_device, torch.uint8, 26, (2, 40, 36, 52), False)
    a = tw.warp_labels_dice_sums(labels, flow, map2, 26, True)
    b = tw.warp_labels_dice_sums(labels, flow, map2, 26, True)
    one = tw.warp_labels_dice_sums(labels[1:], flow[1:], map2[1:], 26, True)
    assert torch.equal(a, b) and torch.equal(a[1:], one)


@pytest.mark.parametrize("zeropad", [False, True])
def test_fused_dice_matches_the_dense_path(cuda_device, zeropad):
    """``warp_onehot_dice_batch`` on the card (K6's and K7's Dice entries)
    against the dense composition through the plain versions and through K6
    and K7: the loss within 1e-5 relative, the flow gradient within 1e-5 of
    its largest entry."""
    L = 26
    labels, flow, map2 = _dice_inputs(cuda_device, torch.uint8, L, (2, 24, 20, 32))
    sides = {}
    for name, fn in (
        ("fused", lambda f: tw.warp_onehot_dice_batch(labels, f, map2, L, zeropad)),
        ("plain", lambda f: tw.warp_onehot_dice_batch(labels, f, map2, L, zeropad, impl="plain")),
        ("dense kernels", lambda f: (tw.dice_loss_zeropad if zeropad else tw.dice_loss)(
            map2, tw.warp_onehot_batch(labels, f, L))),
    ):
        f = flow.clone().requires_grad_()
        d = fn(f)
        (d * 0.7).backward()
        sides[name] = (d.detach(), f.grad)
    d, g = sides["fused"]
    for name in ("plain", "dense kernels"):
        dp, gp = sides[name]
        torch.testing.assert_close(d, dp, atol=0, rtol=1e-5)
        torch.testing.assert_close(g, gp, atol=1e-5 * float(gp.abs().max()), rtol=1e-5)


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


# ---- what a forward and a training step state of their launches -----------

LAUNCH_FORWARDS = {"bf16": ({}, 1), "int8": ({"quantize": "int8"}, 1),
                   "int_res1": ({"int_res": 1}, 1), "slabs2": ({}, 2),
                   "int8_slabs2": ({"quantize": "int8"}, 2)}


@pytest.mark.parametrize("case", sorted(LAUNCH_FORWARDS))
def test_a_forward_launches_what_the_model_states(cuda_device, case):
    """A counted forward, by kernel and by C entry, against
    ``VxmDense.kernel_launches``: width 64 (the int8 convs take 64 input
    channels or more) at 64x32x48, on two X slabs through
    ``parallel/spatial.py``."""
    from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
    from multimodal_registration_torch.parallel.spatial import forward_slabs

    over, slabs = LAUNCH_FORWARDS[case]
    model = VxmDense(VxmConfig(enc=(64,) * 4, dec=(64,) * 6, **over), device=cuda_device).eval()
    model.set_quant_scales({k: 4.0 for k in model.quant_blocks()})
    mov, fx = (torch.rand((1, 64, 32, 48, 1), device=cuda_device) for _ in range(2))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        if slabs == 1:
            model(mov, fx)
        else:
            forward_slabs({cuda_device: model}, [cuda_device] * slabs, mov, fx)
    got = {**kernels.launch_counts(), **kernels.entry_launch_counts()}
    assert got == model.kernel_launches(slabs)


@pytest.mark.parametrize("res", [2, 1])
def test_a_tiled_registration_launches_what_the_registrar_states(cuda_device, res):
    """``Registrar.register_tensors`` with ``use_subvol`` (18 tiles of 32^3
    of a 64x64x48 pair, 5 chunks of 4), counted by kernel and by C entry,
    against ``Registrar.register_launches``: the chunks' forwards without a
    moved image and one general warp of the volume, with the field at half
    and at full resolution."""
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import Registrar, vxm_config_from
    from multimodal_registration_torch.models.vxm_dense import VxmDense

    cfg = InferenceConfig.from_dict(dict(enc=[16] * 4, dec=[16] * 6, int_res=res, svf_res=res,
                                         use_subvol=True, subvol_size=[32, 32, 32]))
    params = VxmDense(vxm_config_from(cfg), device=cuda_device).state_dict()
    reg = Registrar(cfg, params, max_batch=4, device=cuda_device)
    mov, fx = (torch.rand((64, 64, 48), device=cuda_device) for _ in range(2))
    kernels.reset_launch_counts()
    moved, field, scale = reg.register_tensors(mov, fx)
    got = {**kernels.launch_counts(), **kernels.entry_launch_counts()}
    assert got == reg.register_launches(mov.shape)
    assert reg.tile_counts == {"tiles": 18, "slots": 20}
    assert scale == res and moved.shape == mov.shape and bool(torch.isfinite(field).all())


@pytest.mark.parametrize("batch, replicas", [(1, 1), (2, 1), (2, 2)])
def test_a_training_step_launches_what_the_trainer_states(cuda_device, batch, replicas):
    """A counted training step against ``Trainer.step_launches`` at 32^3, 4
    labels, on one device and on two replicas of it."""
    from multimodal_registration_torch.parallel.mesh import make_mesh
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import Trainer

    cfg = TrainConfig.from_dict(dict(
        in_shape=[32, 32, 32], num_labels=4, im_scales=[4, 8], def_scales=[4], vel_res=4.0,
        bias_res=8.0, batch_size=batch, enc=[16] * 4, dec=[16] * 6))
    trainer = Trainer(cfg, mesh=make_mesh(replicas, devices=[cuda_device] * replicas))
    maps = (rand((batch, 32, 32, 32), 94, low=0, high=4)).astype("uint8")
    src, trg = trainer.put_batch(maps, maps[::-1].copy())
    kernels.reset_launch_counts()
    trainer.train_step(trainer.generator(5), src, trg)
    assert kernels.launch_counts() == trainer.step_launches()


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


# ---- multi-GPU (item 15): the slab routes and a data-parallel step ----------
# The mesh repeats cuda:0 (one card is enough): the slabs and replicas are
# split and their halos copied as on several cards.

def _slab_layers(block, space, impl=None):
    from multimodal_registration_torch.parallel.spatial import Slabs

    return Slabs([type("Unet", (), {"enc_0": block})()] * space, impl)


@pytest.mark.parametrize("space", [2, 4])
def test_slab_k1_route_equals_the_unsharded_call(cuda_device, space):
    """enc_0 of the flagship forward, (1, 160, 160, 192, 2) -> 64 in bf16,
    over ``space`` X slabs with a halo of 2: K1 once a slab, and the pooled
    output equal to the unsharded K1 call and to the slabs through K1's plain
    version within 1 bf16 ulp of its magnitude (each output is one float32
    sum rounded once; the tolerance of K1's own tests)."""
    from multimodal_registration_torch.models.unet import ConvBlock
    from multimodal_registration_torch.parallel.mesh import split_slabs

    block = ConvBlock(2, 64, torch.bfloat16, cuda_device)
    x = t(rand((1, 160, 160, 192, 2), 91), torch.bfloat16).to(cuda_device)
    with torch.inference_mode():
        want = block.forward_pooled(x)
        before = kernels.CONV3_LRELU_POOL.launches
        got = torch.cat(_slab_layers(block, space).conv_pooled(
            "enc_0", split_slabs(x, [cuda_device] * space)), dim=1)
        assert kernels.CONV3_LRELU_POOL.launches == before + space
        plain = torch.cat(_slab_layers(block, space, "plain").conv_pooled(
            "enc_0", split_slabs(x, [cuda_device] * space)), dim=1)
    assert got.shape == want.shape == plain.shape == (1, 80, 80, 96, 64)
    tol = bf16_ulp(float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((got.float() - plain.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_k8_route_equals_the_unsharded_call(cuda_device, dtype):
    """dec_3 of the published widths in int8, (1, 80, 80, 96, 512) -> 256,
    over 2 X slabs with a halo of 1: K8 (and its quantize pass) once a slab,
    its int32 sums exact, so the output equals the unsharded call's and the
    slabs' through K8's plain version bit for bit."""
    from multimodal_registration_torch.models.unet import ConvBlock
    from multimodal_registration_torch.parallel.mesh import split_slabs

    block = ConvBlock(512, 256, dtype, cuda_device, quant="int8")
    block.amax = 3.0
    with torch.no_grad():
        block.conv.weight.normal_(0.0, 0.02)
    x = t(rand((1, 80, 80, 96, 512), 92), dtype).to(cuda_device)
    with torch.inference_mode():
        want = block(x)
        before = kernels.CONV3_INT8.launches
        got = torch.cat(_slab_layers(block, 2).conv("enc_0", split_slabs(x, [cuda_device] * 2)),
                        dim=1)
        assert kernels.CONV3_INT8.launches == before + 2
        plain = torch.cat(_slab_layers(block, 2, "plain").conv(
            "enc_0", split_slabs(x, [cuda_device] * 2)), dim=1)
    assert torch.equal(got, want)
    assert torch.equal(got, plain)


def test_data_parallel_step_equals_the_one_device_step(cuda_device):
    """One step of 2 replicas on cuda:0 against the 1-device step (float32,
    32^3, 4 labels, batch 2): the loss to the JAX package's tolerance; the
    parameters within rtol 1e-4 / atol 2e-5, all but at most 1e-4 of them
    (Adam's first step is lr * g / (|g| + eps): where K5's atomic float32
    sums leave a gradient near eps or its sign uncertain, the step may
    differ by up to 2 lr). On one card both replicas are one model, so the
    copy-and-sum of distinct devices is the CPU tests' (``cpu``, ``cpu:0``)."""
    from multimodal_registration_torch.parallel.mesh import make_mesh
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import Trainer

    cfg = TrainConfig.from_dict(dict(
        in_shape=[32, 32, 32], num_labels=4, im_scales=[4, 8], def_scales=[4], vel_res=4.0,
        bias_res=8.0, batch_size=2, num_devices=2, enc=[16] * 4, dec=[16] * 6,
        compute_dtype="float32", lr=1e-4))
    maps = (rand((2, 32, 32, 32), 93, low=0, high=4)).astype("uint8")
    out = []
    for n in (2, 1):
        trainer = Trainer(cfg, mesh=make_mesh(n, devices=[cuda_device] * n))
        trainer.init_state(seed=7)
        aux = trainer.train_step(trainer.generator(5), *trainer.put_batch(maps, maps[::-1].copy()))
        out.append((float(aux["loss"]), {k: (p.detach().clone(), p.grad.clone())
                                         for k, p in trainer.model.named_parameters()}))
    (loss, params), (loss1, params1) = out
    assert abs(loss - loss1) <= 1e-5 + 1e-5 * abs(loss1), (loss, loss1)
    far = total = 0
    for k, (p1, g1) in params1.items():
        p, g = params[k]
        far += int((~torch.isclose(p, p1, rtol=1e-4, atol=2e-5)).sum())
        total += p.numel()
        assert float((p - p1).abs().max()) <= 2 * cfg.lr + 1e-6, k
    assert far <= 1e-4 * total, (far, total)


def test_two_stream_pairs_equal_single_pairs_at_64_cubed(cuda_device):
    """``tools/pair_interleave_probe.py``'s two-stream arm (U(A) on stream 1,
    an event, T(A); U(B) and T(B) on stream 2 behind that event) against each
    pair's single forward on the caller's stream, bit for bit: the same
    kernels and cuDNN calls on the same shapes, whatever the stream. Five
    calls in a row, each one's outputs dropped before the next, so that a
    block the caching allocator handed out again while a stream still read
    it would show; and K1 x1, K2's fused step x5, K3 x1 a pair."""
    from multimodal_registration_torch.tools import pair_interleave_probe as pip

    model, vols, _ = pip.build((64, 64, 64), cuda_device)
    with torch.no_grad():  # a field of voxels, not the initial head's 1e-5
        model.flow.weight.mul_(3e4)
    interleaved = pip.arms(model, vols, cuda_device)["two_interleaved_ms_per_pair"]
    with torch.inference_mode():
        singles = [pip.stage_t(model, m, pip.stage_u(model, m, f))
                   for m, f in (vols[:2], vols[2:])]
        assert float(singles[0][1].abs().max()) > 0.5
        for _ in range(5):
            before = (kernels.CONV3_LRELU_POOL.launches, kernels.WARP_TRILINEAR.launches,
                      kernels.WARP_UP2X.launches)
            got = interleaved()
            torch.cuda.synchronize()
            after = (kernels.CONV3_LRELU_POOL.launches, kernels.WARP_TRILINEAR.launches,
                     kernels.WARP_UP2X.launches)
            assert tuple(a - b for a, b in zip(after, before)) == (2, 10, 2)
            for (gm, gw), (wm, ww) in zip(got, singles):
                assert torch.equal(gm, wm) and torch.equal(gw, ww)
            del got


# ---- K9, the flow head ---------------------------------------------------------------

def _flow_head_case(device, shape, C, dtype, seed):
    feat = t(rand((*shape, C), seed), dtype).to(device)
    w = t(rand((3, C, 3, 3, 3), seed + 1, 0.2)).to(device)
    b = t(rand((3,), seed + 2)).to(device)
    cot = t(rand((*shape, 3), seed + 3)).to(device)
    return feat, w, b, cot


def _flow_head_grads(inputs):
    from multimodal_registration_torch.ops import flow_head as fh

    feat, w, b, cot = inputs
    leaves = [x.detach().clone().requires_grad_() for x in (feat, w, b)]
    out = fh.flow_head_conv(*leaves)
    out.backward(cot)
    return [out.detach()] + [x.grad for x in leaves]


def _share_of_limit(got, want, limit):
    """The largest error as a share of its element's limit."""
    return float(((got.double() - want).abs() / limit.clamp_min(1e-300)).max())


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 64), (torch.bfloat16, 256),
                                     (torch.bfloat16, 5), (torch.bfloat16, 34),
                                     (torch.float32, 64), (torch.float32, 3)])
@pytest.mark.parametrize("shape", [(1, 9, 7, 23), (2, 6, 5, 40), (4, 10, 10, 12)],
                         ids=["z23", "z40", "b4"])
def test_k9_flow_head_matches_plain(cuda_device, dtype, C, shape):
    """K9's three entries against the plain versions in float64, each element
    within its float32 limit (``references_and_limits``); a weight and bias
    gradient of the cotangent rounded to bf16 beyond it. One launch each,
    the weight gradient two; twice the same bits."""
    from multimodal_registration_torch.ops import flow_head as fh

    inputs = _flow_head_case(cuda_device, shape, C, dtype, 40 + C)
    before = dict(kernels.FLOW_HEAD.entry_launches)
    got = _flow_head_grads(inputs)
    torch.cuda.synchronize()
    after = kernels.FLOW_HEAD.entry_launches
    for entry in ("flow_head_fwd_launch", "flow_head_dgrad_launch", "flow_head_wgrad_launch",
                  "flow_head_wgrad_finish_launch"):
        assert after.get(entry, 0) == before.get(entry, 0) + 1, entry
    assert got[1].dtype == dtype and got[0].dtype == got[2].dtype == torch.float32
    want, limits = fh.references_and_limits(*inputs)
    for name, g, r, lim in zip(("svf", "dfeat", "dw", "db"), got, want, limits):
        share = _share_of_limit(g, r, lim)
        assert share <= 1.0, (name, share)
    feat, _, _, cot = inputs
    dw, db = fh._wgrad(feat, cot.bfloat16().float())
    assert _share_of_limit(dw, want[2], limits[2]) > 1.0
    assert _share_of_limit(db, want[3], limits[3]) > 1.0
    again = _flow_head_grads(inputs)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def test_k9_flow_head_in_the_model_and_on_a_halo_slab(cuda_device):
    """``VxmDense.flow_head`` goes through K9 (one launch a forward) and
    equals the plain forward in float64 within its float32 limit; on X slabs
    with a halo, as the sharded forward cuts them, the cropped slabs' heads
    equal the whole volume's bit for bit (the same sums)."""
    from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
    from multimodal_registration_torch.ops.flow_head import references_and_limits
    from multimodal_registration_torch.parallel.spatial import with_halo

    model = VxmDense(VxmConfig(enc=(16,) * 4, dec=(16,) * 6), device=cuda_device)
    with torch.no_grad():
        model.flow.weight.normal_(0.0, 0.1)
    feat, _, _, cot = _flow_head_case(cuda_device, (1, 16, 12, 24), 16, torch.bfloat16, 60)
    with torch.inference_mode():
        before = kernels.FLOW_HEAD.launches
        got = model.flow_head(feat)
        assert kernels.FLOW_HEAD.launches == before + 1
        slabs = torch.cat([model.flow_head(s)[:, 1:-1]
                           for s in with_halo(list(feat.chunk(2, dim=1)), 1)], 1)
    want, limits = references_and_limits(feat, model.flow.weight, model.flow.bias, cot)
    assert _share_of_limit(got, want[0], limits[0]) <= 1.0
    assert torch.equal(slabs, got)
