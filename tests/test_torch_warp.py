"""Port ``ops/warp.py`` (wrappers of kernels K2 and K3, run here as their
plain versions) against the JAX package's. The kernels themselves are held
against their plain versions on the card in ``test_torch_kernels.py``.

Tolerances: float32 linear atol 1e-6 (same trilinear arithmetic, the JAX
einsum sums the 8 corners in another order); nearest exact; bf16 payload
1 bf16 ulp of the output magnitude (both round one float32 mix to bf16, and
the mixes differ in their last float32 bit)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_torch.ops import warp as tw

from _torch_port import bf16_ulp, rand, t

# the JAX ops package re-exports a function named warp: load the module itself
jw = importlib.import_module("multimodal_registration_tpu.ops.warp")

VOL = (12, 10, 14)


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*[jnp.asarray(a) for a in arrays], **kw))


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("amp", [3.0, 50.0], ids=["inside", "clamped"])
@pytest.mark.parametrize("channels", [None, 3])
def test_warp_matches_jax(interp, amp, channels):
    shape = VOL if channels is None else (*VOL, channels)
    vol = rand(shape, 0)
    flow = rand((*VOL, 3), 1, low=-amp, high=amp)
    want = _jax(jw.warp, vol, flow, interp=interp)
    got = tw.warp(t(vol), t(flow), interp=interp).numpy()
    assert got.shape == want.shape
    if interp == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_nearest_half_voxel_rounds_half_to_even():
    """Fault F1: a constant +0.5 flow puts every sample on a tie; JAX rounds
    half to even (jnp.round), so must the port (grid_sample does not)."""
    vol = rand((*VOL, 2), 2)
    flow = np.full((*VOL, 3), 0.5, np.float32)
    want = _jax(jw.warp, vol, flow, interp="nearest")
    got = tw.warp(t(vol), t(flow), interp="nearest").numpy()
    np.testing.assert_array_equal(got, want)
    # x = 0 + 0.5 -> 0 and x = 1 + 0.5 -> 2: half to even, not half up
    np.testing.assert_array_equal(got[0, 0, 0], vol[0, 0, 0])
    np.testing.assert_array_equal(got[1, 1, 1], vol[2, 2, 2])


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_sample_absolute_coords_matches_jax(interp):
    vol = rand(VOL, 3)
    coords = rand((7, 9, 3), 4, low=-3.0, high=16.0)
    want = _jax(jw.sample, vol, coords, interp=interp)
    got = tw.sample(t(vol), t(coords), interp=interp).numpy()
    assert got.shape == want.shape == (7, 9)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_warp_batch_bf16_payload_matches_jax():
    vol = rand((2, *VOL, 3), 5)
    flow = rand((2, *VOL, 3), 6, low=-4.0, high=4.0)
    want = np.asarray(jw.warp_batch(jnp.asarray(vol, jnp.bfloat16), jnp.asarray(flow)),
                      np.float32)
    got = tw.warp_batch(t(vol, torch.bfloat16), t(flow))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= bf16_ulp(np.abs(want).max()), err


def test_warp_up2x_batch_matches_jax():
    vol = rand((2, 16, 12, 20, 1), 7)
    fh = rand((2, 8, 6, 10, 3), 8, low=-3.0, high=3.0)
    want = _jax(jw.warp_up2x_batch, vol, fh)
    got = tw.warp_up2x_batch(t(vol), t(fh)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    got4 = tw.warp_up2x_batch(t(vol[..., 0]), t(fh)).numpy()
    np.testing.assert_allclose(got4, want[..., 0], atol=1e-5, rtol=0)


def test_bad_arguments_raise():
    vol, flow = t(rand(VOL, 9)), t(np.zeros((*VOL, 3)))
    with pytest.raises(ValueError):
        tw.warp(vol, flow, impl="kernel-please")
    with pytest.raises(ValueError):
        tw.warp(vol, flow, interp="cubic")
    with pytest.raises(ValueError):
        tw.warp_up2x_batch(vol[None], t(np.zeros((1, 5, 5, 7, 3))))
    with pytest.raises(ValueError):  # only cpu (plain) and cuda (kernel)
        tw.warp(vol.to("meta"), flow.to("meta"))

