"""Port ``ops/resize.py`` against the JAX package's (CPU, float32).

Tolerance: atol 1e-6 on values of order 1 — both sides compute the same
float32 interpolation; only the summation order of the non-integer zooms'
matrix products differs."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_registration_torch.ops import resize as tr

from _torch_port import rand, t

# the JAX ops package re-exports a function named resize: load the module itself
jr = importlib.import_module("multimodal_registration_tpu.ops.resize")

CASES = [
    ((8, 6, 10, 3), 2, None),
    ((8, 6, 10), 2, None),
    ((8, 6, 10, 3), 0.5, None),
    ((9, 7, 11, 2), 1.5, None),
    ((9, 7, 11), (0.7, 1.3, 2.0), None),
    ((8, 6, 10, 3), 2, (15, 12, 20)),
]


@pytest.mark.parametrize("shape,zoom,out_shape", CASES)
def test_resize_matches_jax(shape, zoom, out_shape):
    v = rand(shape, 0)
    want = np.asarray(jr.resize(jnp.asarray(v), zoom, out_shape=out_shape))
    got = tr.resize(t(v), zoom, out_shape=out_shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("factor,out_shape", [(2, None), (0.5, None), (1.5, None),
                                              ((2.0, 2.0, 1.5), (16, 12, 15))])
def test_rescale_field_matches_jax(factor, out_shape):
    f = rand((8, 6, 10, 3), 1, scale=2.0)
    want = np.asarray(jr.rescale_field(jnp.asarray(f), factor, out_shape=out_shape))
    got = tr.rescale_field(t(f), factor, out_shape=out_shape).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_upsample2x_is_the_interleave():
    # out[2i] = v[i], out[2i+1] = (v[i] + v[i+1]) / 2, edge-clamped
    v = rand((5,), 2)
    got = tr._upsample2x_axis(t(v), 0).numpy()
    np.testing.assert_array_equal(got[0::2], v)
    np.testing.assert_array_equal(got[1::2], 0.5 * (v + np.append(v[1:], v[-1])))
