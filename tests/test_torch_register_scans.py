"""Port ``register()`` on scans off the fixed 1 mm grid against the JAX
package's: an anisotropic fixed scan (0.8 x 0.8 x 1.2 mm) and an anisotropic
moving scan (0.625 x 0.625 x 2 mm) of the same field of view, axis-aligned
and rotated 6 degrees about z and shifted 2 mm (oblique). Preprocessing
resamples with 'linear' (kernel K2's plain version) or 'spline' (the
quadratic device spline); the postprocess resamples the moved image and the
field back onto the moving grid with the cubic device spline, separable or
oblique.

Tolerances by ``assert_same_outputs``: fields within 1 bf16 ulp of their
magnitude (fault F2), moved intensities within that or 1e-3, inputs and
preprocessed volumes within 1e-5."""

import importlib

import numpy as np
import pytest

from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import assert_same_outputs, random_flat_params, scan_affine, write_scan_pair

jreg = importlib.import_module("multimodal_registration_tpu.infer.register")

ARCH = dict(enc=[8] * 4, dec=[8] * 6, int_steps=5, int_res=2, svf_res=2,
            compute_dtype="float32")
FIXED = ((40, 40, 32), (0.8, 0.8, 1.2))
MOVING = ((48, 48, 16), (0.625, 0.625, 2.0))


@pytest.fixture(scope="module")
def registrars(tmp_path_factory):
    jcfg = JaxVxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in ARCH.items()})
    path = str(tmp_path_factory.mktemp("ckpt") / "w.npz")
    np.savez(path, **random_flat_params(jcfg, seed=6))
    jc, tc = jconf.InferenceConfig.from_dict(dict(ARCH)), tconf.InferenceConfig.from_dict(dict(ARCH))
    return (jreg.Registrar(jc, jreg.load_params_any(path, jc)),
            treg.Registrar(tc, treg.load_params_any(path, tc), device="cpu"))


@pytest.mark.parametrize("resample", ["linear", "spline"])
@pytest.mark.parametrize("pose", ["axis_aligned", "oblique"])
def test_register_off_grid_matches_jax(tmp_path, registrars, pose, resample):
    rot, shift = (6.0, (2.0, 0.0, 0.0)) if pose == "oblique" else (0.0, (0.0, 0.0, 0.0))
    fixed = (FIXED[0], scan_affine(*FIXED))
    moving = (MOVING[0], scan_affine(*MOVING, rot_deg=rot, shift=shift))
    outs = []
    for d, nifti_mod, conf, reg, r in ((tmp_path / "jax", jnifti, jconf, jreg, registrars[0]),
                                       (tmp_path / "port", tnifti, tconf, treg, registrars[1])):
        write_scan_pair(str(d), nifti_mod, fixed, moving)
        cfg = conf.InferenceConfig.from_dict(dict(ARCH, resample_interpolation=resample))
        outs.append(reg.register(cfg, r, str(d / "fx.nii.gz"), str(d / "mov.nii.gz"),
                                 fx_contrast="T2w", naming="standalone",
                                 res_dir=str(d / "res")))
    jout, tout = outs
    assert np.abs(jout["warp_data"]).max() > 0.2  # a real field, not the identity
    assert tout["moved_orig"].shape == MOVING[0]
    assert tout["warp"].shape == (32, 32, 32, 1, 3)  # the 1 mm grid, rounded to 16
    assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))
