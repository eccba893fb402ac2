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
difference)."""

import pytest
import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops import conv_pool as tcp
from multimodal_registration_torch.ops import warp as tw

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
