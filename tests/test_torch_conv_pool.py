"""Port ``ops/conv_pool.py`` (the wrapper of kernel K1, run here as its plain
version) against the JAX package's reference and its Pallas kernel in
interpret mode. The kernel itself is held against its plain version on the
card in ``test_torch_kernels.py``.

Tolerances: float32 atol 1e-5 (one 54-term float32 sum per output, summed in
another order); bfloat16 output 1 bf16 ulp of the output magnitude (both
sides round the same float32 value once, which may sit on either side of a
rounding boundary after a last-bit difference)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import multimodal_registration_tpu.ops.pallas.conv_pool as jcp
from multimodal_registration_torch.ops import conv_pool as tcp

from _torch_port import bf16_ulp, rand, t


@pytest.fixture()
def interpret_pallas(monkeypatch):
    # the same patch as tests/test_conv_pool.py: Mosaic needs a TPU backend
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jcp.pl, "pallas_call", patched)


def _torch_w(w_jax):
    """(3, 3, 3, Cin, Cout) -> (Cout, Cin, 3, 3, 3)."""
    return t(np.ascontiguousarray(w_jax.transpose(4, 3, 0, 1, 2)))


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape,cout", [((8, 6, 10, 2), 5), ((4, 8, 6, 1), 4)])
def test_plain_matches_jax_reference_f32(shape, cout):
    x = rand(shape, 0)
    w = rand((3, 3, 3, shape[-1], cout), 1, 0.2)
    b = rand((cout,), 2)
    want = np.asarray(jcp.conv3_lrelu_pool_reference(jnp.asarray(x), jnp.asarray(w),
                                                     jnp.asarray(b)))
    got = tcp.conv3_lrelu_pool(t(x)[None], _torch_w(w), t(b)).numpy()[0]
    assert got.shape == want.shape == (shape[0] // 2, shape[1] // 2, shape[2] // 2, cout)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_bf16_rounds_operands_and_output_once():
    x = rand((8, 8, 6, 2), 3)
    w = rand((3, 3, 3, 2, 6), 4, 0.2)
    b = rand((6,), 5)
    # reference on the bf16-rounded operands, in float32
    want = np.asarray(jcp.conv3_lrelu_pool_reference(
        jnp.asarray(_bf16_round(x)), jnp.asarray(_bf16_round(w)), jnp.asarray(b)))
    got = tcp.conv3_lrelu_pool(t(x, torch.bfloat16)[None], _torch_w(w), t(b))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy()[0] - want).max()
    assert err <= bf16_ulp(np.abs(want).max()), err


def test_plain_matches_pallas_kernel_interpret(interpret_pallas):
    """One tiny shape through the Pallas kernel itself (two grid steps: the
    interpreter is slow). The kernel rounds x and w to bf16 and sums in
    float32; the port gets the same rounded operands in float32."""
    x = rand((4, 4, 8, 2), 6)
    w = rand((3, 3, 3, 2, 4), 7, 0.3)
    b = rand((4,), 8)
    want = np.asarray(jcp.conv3_lrelu_pool(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                           block=(2, 4), out_dtype=jnp.float32))
    got = tcp.conv3_lrelu_pool(t(_bf16_round(x))[None], _torch_w(_bf16_round(w)),
                               t(b)).numpy()[0]
    assert got.shape == want.shape == (2, 2, 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bad_shapes_raise():
    x = t(rand((1, 8, 8, 8, 2), 9))
    with pytest.raises(ValueError):  # Cin of w does not match x
        tcp.conv3_lrelu_pool(x, t(np.zeros((4, 3, 3, 3, 3))), t(np.zeros(4)))
    with pytest.raises(ValueError):  # odd spatial dim
        tcp.conv3_lrelu_pool(x[:, :7], t(np.zeros((4, 2, 3, 3, 3))), t(np.zeros(4)))
    with pytest.raises(ValueError):  # impl is None or "plain"
        tcp.conv3_lrelu_pool(x, t(np.zeros((4, 2, 3, 3, 3))), t(np.zeros(4)), impl="fast")

