"""Port the subvolume path of ``register()`` (``infer/blend.py`` and the
``use_subvol`` branch of ``infer/register.py``) against the JAX package's.

The pair is off the fixed grid (the moving scan at 1.2 x 1.2 x 1.5 mm, the
fixed one at 1 mm), so preprocessing resamples and the postprocess runs the
cubic device spline back to the moving grid. The tiles (2 x 2 x 2 of 32^3 in
a 48^3 volume) go through the model in chunks of ``max_batch`` 3, the last
one padded, at field scale 1 (``int_res`` 1) and 2 (the tile, volume and
coordinates halved).

Tolerances: ``pyramid_weights`` equal; ``blend_subvol_fields`` 1e-6 (the
same float32 sums in the same order); ``register()`` outputs by
``assert_same_outputs``: fields within 1 bf16 ulp of their magnitude (fault
F2), moved intensities 1e-3, nearest-warped images in all but 0.1% of their
voxels."""

import importlib
import os

import numpy as np
import pytest

from multimodal_registration_tpu.infer import blend as jblend
from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import blend as tblend
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import (assert_same_outputs, bf16_ulp, rand, random_flat_params, scan_affine,
                         write_scan_pair)

# the JAX infer package re-exports functions named like these modules
jreg = importlib.import_module("multimodal_registration_tpu.infer.register")
jpre = importlib.import_module("multimodal_registration_tpu.infer.preprocess")

FIXED = ((48, 48, 48), (1.0, 1.0, 1.0))
MOVING = ((40, 40, 32), (1.2, 1.2, 1.5))
SUBVOL = dict(use_subvol=True, subvol_size=[32, 32, 32], min_perc_overlap=0.2)


@pytest.mark.parametrize("shape", [(32, 32, 32), (16, 8, 12), (7, 9, 5)])
def test_pyramid_weights_equal(shape):
    np.testing.assert_array_equal(tblend.pyramid_weights(shape), jblend.pyramid_weights(shape))


@pytest.mark.parametrize("scale", [1, 2])
def test_blend_matches_jax(scale):
    cfg = jconf.InferenceConfig.from_dict(dict(use_subvol=True, subvol_size=[16, 16, 16],
                                               min_perc_overlap=0.25))
    vol_shape = (32, 48, 40)
    tile, coords = jpre.subvol_grid(cfg, vol_shape)
    assert len(coords) > 8
    tile = tuple(s // scale for s in tile)
    vol_shape = tuple(s // scale for s in vol_shape)
    coords = [tuple(c // scale for c in co) for co in coords]
    warps = rand((len(coords), *tile, 3), seed=scale)
    want = np.asarray(jblend.blend_subvol_fields(tile, vol_shape, coords, list(warps)))
    got = tblend.blend_subvol_fields(tile, vol_shape, coords, warps, device="cpu").numpy()
    assert got.shape == (*vol_shape, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _arch(scale):
    return dict(enc=[8] * 4, dec=[8] * 6, int_steps=5, int_res=scale, svf_res=scale,
                compute_dtype="float32")


@pytest.fixture(scope="module", params=[1, 2], ids=["scale1", "scale2"])
def registrars(request, tmp_path_factory):
    """One registrar of each package per field scale, shared by the linear
    and nearest tests (the JAX one compiles once)."""
    arch = _arch(request.param)
    jcfg = JaxVxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})
    path = str(tmp_path_factory.mktemp("ckpt") / "w.npz")
    np.savez(path, **random_flat_params(jcfg, seed=8))
    jc = jconf.InferenceConfig.from_dict(dict(arch, **SUBVOL))
    tc = tconf.InferenceConfig.from_dict(dict(arch, **SUBVOL))
    return (request.param,
            jreg.Registrar(jc, jreg.load_params_any(path, jc), max_batch=3),
            treg.Registrar(tc, treg.load_params_any(path, tc), max_batch=3, device="cpu"))


@pytest.mark.parametrize("warp_interpolation", ["linear", "nearest"])
def test_register_subvol_matches_jax(tmp_path, registrars, warp_interpolation):
    scale, jr, tr = registrars
    settings = dict(_arch(scale), **SUBVOL, warp_interpolation=warp_interpolation)
    fixed = (FIXED[0], scan_affine(*FIXED))
    moving = (MOVING[0], scan_affine(*MOVING))
    outs = []
    for d, nifti_mod, conf, reg, r in (
            (tmp_path / "jax", jnifti, jconf, jreg, jr), (tmp_path / "port", tnifti, tconf, treg, tr)):
        write_scan_pair(str(d), nifti_mod, fixed, moving)
        cfg = conf.InferenceConfig.from_dict(dict(settings))
        outs.append(reg.register(cfg, r, str(d / "fx.nii.gz"), str(d / "mov.nii.gz"),
                                 fx_contrast="T2w", naming="bids"))
    jout, tout = outs
    assert tout["scale"] == jout["scale"] == scale
    assert set(tout["timings"]) == set(jout["timings"])
    assert np.abs(jout["warp_data"]).max() > 0.2  # a real field, not the identity
    np.testing.assert_allclose(tout["warp_data"], jout["warp_data"], rtol=0,
                               atol=bf16_ulp(np.abs(jout["warp_data"]).max()))
    names = assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"),
                                nearest=warp_interpolation == "nearest")
    assert "mov_warp_original_dim.nii.gz" in names
    assert tnifti.load(os.path.join(tmp_path, "port", "mov_reg_original_dim.nii.gz")).shape == \
        MOVING[0]
