"""Port ``ops/resample.py`` against the JAX package's: grid-to-grid affine
resampling of orders 0 and 1 (kernel K2's plain version here), the identity
fast paths, and ``resample_nib`` to 1 mm.

Tolerances: linear atol 1e-5 on values of order 1 (the same float32
coordinates and trilinear mix; the affine product and the corner sum run in
another order); nearest exact (no sample lands on a half-voxel tie under
these affines); identity paths exact."""

import importlib

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU backend of conftest)
import numpy as np
import pytest

from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.ops import resample as tres
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import rand

jres = importlib.import_module("multimodal_registration_tpu.ops.resample")

# a rotation about z, anisotropic scale and a shift: every sample is oblique
_C, _S = np.cos(0.3), np.sin(0.3)
IN_AFF = np.array([[1.2 * _C, -_S, 0.0, 3.0],
                   [1.2 * _S, _C, 0.0, -2.0],
                   [0.0, 0.0, 0.8, 1.5],
                   [0.0, 0.0, 0.0, 1.0]])
OUT_AFF = np.diag([1.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("interp", ["linear", "nn"])
@pytest.mark.parametrize("channels", [None, 3])
def test_affine_resample_matches_jax(interp, channels):
    shape = (14, 12, 10) if channels is None else (14, 12, 10, channels)
    vol = rand(shape, 0, low=0.0, high=1.0)
    want = jres.affine_resample(vol, IN_AFF, OUT_AFF, (16, 13, 9), interp)
    got = tres.affine_resample(vol, IN_AFF, OUT_AFF, (16, 13, 9), interp, device="cpu")
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape
    assert (want == 0).any() and (want != 0).any()  # samples inside and outside
    if interp == "nn":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("interp", ["linear", "nn", "spline", "spline2"])
def test_identity_map_paths_match_jax(interp):
    vol = rand((10, 9, 8), 1)
    aff = np.diag([2.0, 1.0, 1.5, 1.0])
    for out_shape in ((10, 9, 8), (12, 7, 8)):  # same grid; pad and crop
        want = jres.affine_resample(vol, aff, aff, out_shape, interp)
        got = tres.affine_resample(vol, aff, aff, out_shape, interp, device="cpu")
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_resample_nib_to_1mm_matches_jax():
    data = rand((12, 10, 8), 2, low=0.0, high=1.0)
    aff = np.diag([1.5, 1.25, 2.0, 1.0])
    want = jres.resample_nib(jnifti.NiftiImage(data, aff), new_size=[1, 1, 1],
                             new_size_type="mm", interpolation="linear", mode="constant")
    got = tres.resample_nib(tnifti.NiftiImage(data, aff), new_size=[1, 1, 1],
                            new_size_type="mm", interpolation="linear", mode="constant",
                            device="cpu")
    assert got.shape == want.shape == (18, 12, 16)
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_allclose(got.get_fdata(), want.get_fdata(), atol=1e-5, rtol=0)


def test_pad_or_crop_matches_jax():
    vol = rand((5, 6, 7, 2), 3)
    # the JAX function takes 3-D volumes; the port's carries channels along
    got = tres.pad_or_crop(vol, (8, 4, 7))
    assert got.shape == (8, 4, 7, 2)
    for c in range(2):
        np.testing.assert_array_equal(got[..., c], jres.pad_or_crop(vol[..., c], (8, 4, 7)))
