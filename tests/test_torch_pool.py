"""The port's max-pool adjoint (plain versions of kernel K4) against the JAX
package: ``tie="first"`` against the Pallas kernels ``max_pool_2x_bwd`` and
``max_pool_2x_bwd_v3`` in interpret mode, ``tie="equal"`` against ``jax.grad``
through ``ops.pool.max_pool_2x``. Inputs have planted ties (values on a coarse
grid), so the tie rules matter. Everything is compares and one division:
exact, no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.ops import pool as jpool
from multimodal_registration_tpu.ops.pallas import pool_bwd as jpb
from multimodal_registration_torch.ops import pool as tpool

from _torch_port import rand, t

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def tied(shape, seed):
    return (np.random.default_rng(seed).integers(-3, 4, size=shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["max_pool_2x_bwd", "max_pool_2x_bwd_v3"])
def test_first_equals_pallas_kernels_in_interpret_mode(jdt, tdt, kernel):
    x = tied((2, 8, 4, 16, 8), 1)  # batch 2: the Pallas kernels take one element
    g = rand((2, 4, 2, 8, 8), 2)
    got = tpool.max_pool_2x_bwd(t(x, tdt), t(g, tdt), "first")
    assert got.dtype == tdt
    fn = getattr(jpb, kernel)
    for b in range(2):
        want = fn(jnp.asarray(x[b], jdt), jnp.asarray(g[b], jdt), interpret=True)
        np.testing.assert_array_equal(got[b].float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # ties were really there, and first routes all of g to one voxel per window
    w = tpool._windows(got.float())
    assert int((w != 0).sum(dim=(2, 4, 6)).max()) == 1


def test_first_is_the_tournament_not_row_major_order():
    x = np.zeros((1, 2, 2, 2, 1), np.float32)
    x[0, 0, 1, 0, 0] = x[0, 1, 0, 0, 0] = 1.0  # (x0,y1,z0) and (x1,y0,z0) tie
    g = np.full((1, 1, 1, 1, 1), 3.0, np.float32)
    got = tpool.max_pool_2x_bwd(t(x), t(g), "first").numpy()
    assert got[0, 1, 0, 0, 0] == 3.0 and got.sum() == 3.0  # the tournament's winner
    want = jpb.max_pool_2x_bwd(jnp.asarray(x[0]), jnp.asarray(g[0]), block=(2, 2), interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want))
    # PyTorch's own backward picks the first maximum in scan order instead
    xt = t(x).permute(0, 4, 1, 2, 3).requires_grad_()
    torch.nn.functional.max_pool3d(xt, 2, 2).sum().backward()
    assert xt.grad[0, 0, 0, 1, 0] == 1.0


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 10, 3), (1, 7, 6, 9, 2)], ids=["even", "odd"])
def test_equal_equals_jax_grad_of_max_pool_2x(jdt, tdt, shape):
    x = tied(shape, 3)
    gshape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4])
    g = rand(gshape, 4)
    y, vjp = jax.vjp(jpool.max_pool_2x, jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    xt = t(x, tdt).requires_grad_()
    yt = tpool.max_pool_2x(xt)  # tie="equal" is the default, as in the JAX package
    np.testing.assert_array_equal(yt.detach().float().numpy(), np.asarray(y.astype(jnp.float32)))
    yt.backward(t(g, tdt))
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if shape[1] % 2:
        assert float(xt.grad[:, -1].abs().max()) == 0.0  # the dropped plane


def test_unbatched_and_bad_arguments():
    x = t(tied((6, 4, 8, 2), 5)).requires_grad_()
    y = tpool.max_pool_2x(x, tie="first")
    assert y.shape == (3, 2, 4, 2)
    y.sum().backward()
    assert float(x.grad.sum()) == y.numel()
    with pytest.raises(ValueError, match="tie"):
        tpool.max_pool_2x(x, tie="last")
    with pytest.raises(ValueError, match="pooled shape"):
        tpool.max_pool_2x_bwd(torch.zeros(1, 4, 4, 4, 1), torch.zeros(1, 2, 2, 3, 1))
