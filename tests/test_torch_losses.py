"""The port's training losses against the JAX package's, values and
gradients, on the same numpy inputs. float32 reductions in another order:
atol/rtol 1e-5 for values, 1e-6 absolute for gradients (they are of order
1/volume)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.losses import losses as jl
from multimodal_registration_torch.losses import losses as tl

from _torch_port import rand, t

SHAPE = (2, 8, 6, 10)


def soft_maps(seed, L=5, pad=False):
    rng = np.random.default_rng(seed)
    m = rng.random((*SHAPE, L)).astype(np.float32)
    m /= m.sum(-1, keepdims=True)
    if pad:  # a slab of pure background, as zero-border augmentation makes
        m[:, :2] = 0.0
        m[:, :2, ..., 0] = 1.0
    return m


def both(tfn, jfn, *arrays, wrt=1):
    xs = [t(a) for a in arrays]
    xs[wrt].requires_grad_()
    val = tfn(*xs)
    val.backward()
    jval, jgrad = jax.value_and_grad(jfn, argnums=wrt)(*[jnp.asarray(a) for a in arrays])
    return float(val), xs[wrt].grad.numpy(), float(jval), np.asarray(jgrad)


@pytest.mark.parametrize("name,pad", [("dice_loss", False), ("dice_loss_zeropad", True),
                                      ("dice_loss_zeropad", False)])
def test_dice_losses(name, pad):
    y_true, y_pred = soft_maps(1, pad=pad), soft_maps(2, pad=pad)
    v, g, jv, jg = both(getattr(tl, name), getattr(jl, name), y_true, y_pred)
    np.testing.assert_allclose(v, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g, jg, atol=1e-6, rtol=1e-4)
    assert np.abs(g).max() > 0


def test_dice_of_an_empty_channel_is_zero_with_a_zero_gradient():
    y_true, y_pred = soft_maps(3), soft_maps(4)
    y_true[..., 2] = 0.0
    y_pred[..., 2] = 0.0  # denominator 0: divide_no_nan gives 0, not NaN
    v, g, jv, jg = both(tl.dice_loss, jl.dice_loss, y_true, y_pred)
    assert np.isfinite(v) and np.isfinite(g).all()
    np.testing.assert_allclose(v, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g, jg, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("penalty,mult", [("l2", 1.0), ("l2", None), ("l1", 0.5)])
def test_grad_loss(penalty, mult):
    flow = rand((*SHAPE, 3), 5, 2.0)
    v, g, jv, jg = both(lambda f: tl.grad_loss(f, penalty, mult),
                        lambda f: jl.grad_loss(f, penalty, mult), flow, wrt=0)
    np.testing.assert_allclose(v, jv, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g, jg, atol=1e-6, rtol=1e-4)


def test_mse_and_ncc_losses():
    a, b = rand((*SHAPE, 1), 6), rand((*SHAPE, 1), 7)
    v, g, jv, jg = both(tl.mse_loss, jl.mse_loss, a, b)
    np.testing.assert_allclose(v, jv, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(g, jg, atol=1e-6, rtol=1e-4)
    for win in (5, 4):  # odd and even windows pad differently
        v, g, jv, jg = both(lambda x, y: tl.ncc_loss(x, y, win=win),
                            lambda x, y: jl.ncc_loss(x, y, win=win), a, b)
        np.testing.assert_allclose(v, jv, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(g, jg, atol=1e-5, rtol=1e-3)
