"""Port the device spline of ``ops/resample.py`` against the JAX package's
and against scipy: the separable path (a scaled permutation: three exact 1-D
operators) and the oblique path (the prefilter as three operators, then the
(order+1)^3-tap sampler), orders 2 and 3, modes 'nearest' and 'constant',
``cval`` 0 and 0.7, 3-D volumes and 4-D ones whose channels ride along, and
shapes with a length-1 axis (the mirror fold's ``n == 1``).

Tolerances, relative to max|vol|: 1e-5 against the JAX package (both
float32; the operator products and the tap sums run in another order),
1e-4 against ``scipy.ndimage.affine_transform`` in float64. The host route
of an oblique spline in another mode is scipy in both packages: equal."""

import importlib

import jax.numpy as jnp  # noqa: F401  (keeps JAX on the CPU backend of conftest)
import numpy as np
import pytest
import torch
from scipy.ndimage import affine_transform

from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch import device as tdevice
from multimodal_registration_torch.ops import resample as tres
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import rand

jres = importlib.import_module("multimodal_registration_tpu.ops.resample")

_C, _S = np.cos(0.2), np.sin(0.2)
# voxel maps M = inv(A_in) @ A_out, used with A_in = identity
MAPS = {
    # a permutation with scales, a flip and offsets: separable
    "separable": np.array([[0.0, 1.3, 0.0, -0.6],
                           [0.8, 0.0, 0.0, 1.1],
                           [0.0, 0.0, -1.0, 6.5],
                           [0.0, 0.0, 0.0, 1.0]]),
    # a rotation about z with scales and a shift: oblique in x and y
    "oblique": np.array([[1.1 * _C, -_S, 0.0, 0.7],
                         [1.1 * _S, _C, 0.0, -1.2],
                         [0.0, 0.0, 0.9, 0.4],
                         [0.0, 0.0, 0.0, 1.0]]),
}
# (input shape, output shape): 3-D; 4-D with 3 channels; a length-1 z axis
# that the map keeps at coordinate 0 (mirror and clamp fold of n == 1)
SHAPES = {"3d": ((9, 8, 7), (10, 9, 6)), "4d": ((9, 8, 7, 3), (10, 9, 6)),
          "n1": ((9, 8, 1), (10, 9, 1))}
CASES = [(kind, order, mode, cval, shapes)
         for kind in MAPS for order in (2, 3)
         for mode, cval in (("constant", 0.0), ("constant", 0.7), ("nearest", 0.7))
         for shapes in SHAPES]


def _map(kind, shapes):
    M = MAPS[kind].copy()
    if shapes == "n1":
        M[2] = [0.0, 0.0, 1.0, 0.0]  # z = 0 exactly on the one output plane
    return M


def _scipy(vol, M, out_shape, order, mode, cval):
    def one(v):
        return affine_transform(v.astype(np.float64), M[:3, :3], offset=M[:3, 3],
                                output_shape=out_shape, order=order, mode=mode, cval=cval)
    if vol.ndim == 3:
        return one(vol)
    return np.stack([one(vol[..., c]) for c in range(vol.shape[3])], -1)


@pytest.mark.parametrize("kind,order,mode,cval,shapes", CASES)
def test_spline_matches_jax_and_scipy(kind, order, mode, cval, shapes):
    in_shape, out_shape = SHAPES[shapes]
    vol = rand(in_shape, seed=len(CASES) + CASES.index((kind, order, mode, cval, shapes)))
    M = _map(kind, shapes)
    interp = {2: "spline2", 3: "spline"}[order]
    want = jres.affine_resample(vol, np.eye(4), M, out_shape, interp, mode=mode, cval=cval)
    got = tres.affine_resample(vol, np.eye(4), M, out_shape, interp, mode=mode, cval=cval,
                               device="cpu")
    ref = _scipy(vol, M, out_shape, order, mode, cval)
    assert got.dtype == np.float64 and got.shape == want.shape == ref.shape
    m = float(np.abs(vol).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * m, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-4 * m, rtol=0)
    if mode == "constant":  # samples inside and outside the input
        assert (ref == cval).any() and (ref != cval).any()


def test_oblique_map_samples_between_taps():
    """Coordinates on and next to tap boundaries (integer and half-integer
    positions, where floor switches): the B-spline is continuous, so the
    port stays within the tolerances there too."""
    vol = rand((12, 11, 10), 5)
    M = np.array([[1.0, 0.0, 0.0, 0.5], [0.0, 0.5, 0.5, 1.0],
                  [0.0, -0.5, 0.5, 3.0], [0.0, 0.0, 0.0, 1.0]])
    for order, interp in ((2, "spline2"), (3, "spline")):
        want = jres.affine_resample(vol, np.eye(4), M, (12, 14, 12), interp)
        got = tres.affine_resample(vol, np.eye(4), M, (12, 14, 12), interp, device="cpu")
        ref = _scipy(vol, M, (12, 14, 12), order, "constant", 0.0)
        m = float(np.abs(vol).max())
        np.testing.assert_allclose(got, want, atol=1e-5 * m, rtol=0)
        np.testing.assert_allclose(got, ref, atol=1e-4 * m, rtol=0)


@pytest.mark.parametrize("kind", list(MAPS))
def test_other_modes(kind):
    """Separable maps run every scipy mode on the device (its operator is
    extracted in that mode); an oblique map in a mode other than 'nearest'
    and 'constant' goes to scipy on the host, in both packages."""
    vol = rand((9, 8, 7), 6)
    M = MAPS[kind]
    want = jres.affine_resample(vol, np.eye(4), M, (10, 9, 6), "spline", mode="reflect")
    got = tres.affine_resample(vol, np.eye(4), M, (10, 9, 6), "spline", mode="reflect",
                               device="cpu")
    assert tres.spline_on_device(M, "reflect") == (kind == "separable")
    if kind == "separable":
        np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(vol).max()), rtol=0)
    else:
        np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="host"):
            tres.device_spline_resample(torch.as_tensor(vol), M, (10, 9, 6), "reflect")


def test_resample_nib_spline_is_quadratic_and_matches_jax():
    """``resample_nib``'s 'spline' is order 2, here from an anisotropic grid
    to 1 mm (separable) and onto a rotated destination (oblique)."""
    data = rand((12, 10, 8), 7, low=0.0, high=1.0)
    aff = np.diag([1.5, 1.25, 2.0, 1.0])
    kw = dict(new_size=[1, 1, 1], new_size_type="mm", interpolation="spline", mode="constant")
    want = jres.resample_nib(jnifti.NiftiImage(data, aff), **kw)
    got = tres.resample_nib(tnifti.NiftiImage(data, aff), device="cpu", **kw)
    np.testing.assert_allclose(got.get_fdata(), want.get_fdata(), atol=1e-5, rtol=0)
    rot = np.array([[_C, -_S, 0.0, 1.0], [_S, _C, 0.0, -2.0], [0, 0, 1.0, 0.5], [0, 0, 0, 1.0]])
    want = jres.resample_nib(jnifti.NiftiImage(data, aff), image_dest=jnifti.NiftiImage(
        np.zeros((14, 12, 12)), rot), interpolation="spline", mode="constant")
    got = tres.resample_nib(tnifti.NiftiImage(data, aff), image_dest=tnifti.NiftiImage(
        np.zeros((14, 12, 12)), rot), interpolation="spline", mode="constant", device="cpu")
    np.testing.assert_allclose(got.get_fdata(), want.get_fdata(), atol=1e-5, rtol=0)


def test_full_fp32_matmuls_restores_the_callers_setting():
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    try:
        for setting in (True, False):
            matmul.allow_tf32 = setting
            with tdevice.full_fp32_matmuls():
                assert matmul.allow_tf32 is False
            assert matmul.allow_tf32 is setting
    finally:
        matmul.allow_tf32 = old
