"""Port ``infer/register.py`` (``register()`` end to end on the CPU) against
the JAX package's on the same synthetic 1 mm NIfTI pair and the same tiny
float32 checkpoint: the same output files, decoding to the same headers
(every field but ``descrip``, which names the package that wrote the file)
and the same data.

Tolerances. The inputs and the preprocessed volumes: exact (the same float64
arithmetic). The network is float32 but, as in both packages' default, each
squaring step rounds the warped field to bfloat16; a last-bit difference of a
float32 conv sum can flip one of those roundings, so fields may differ by 1
bf16 ulp of their magnitude, and linearly moved intensities (in [0, 1]) by
1e-3. Nearest-neighbour moved images: a sample whose field differs slightly
may fall on the other side of a half-voxel tie, so at most 0.1% of voxels
may differ, and every voxel still holds a value of the moving image."""

import importlib
import os

import numpy as np
import pytest

from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import bf16_ulp, random_flat_params, synthetic_pair

# the JAX infer package re-exports a function named register: load the module
jreg = importlib.import_module("multimodal_registration_tpu.infer.register")

SHAPE = (32, 32, 48)
ARCH = dict(enc=[8] * 4, dec=[8] * 6, int_steps=5, int_res=2, svf_res=2,
            compute_dtype="float32")
HEADER_FIELDS = ("dim", "datatype", "bitpix", "pixdim", "vox_offset", "scl_slope",
                 "scl_inter", "intent_code", "qform_code", "sform_code", "quatern",
                 "qoffset", "srow", "xyzt_units", "cal_max", "cal_min")
# an oblique-free but non-RAS orientation, so the RAI export permutes and flips
AFFINE = np.array([[0.0, 0.0, 1.0, -20.0],
                   [-1.0, 0.0, 0.0, 15.0],
                   [0.0, 1.0, 0.0, -8.0],
                   [0.0, 0.0, 0.0, 1.0]])


def _write_inputs(d, nifti_mod):
    fx, mov = synthetic_pair(SHAPE, seed=3)
    os.makedirs(d, exist_ok=True)
    nifti_mod.save(nifti_mod.NiftiImage(fx, AFFINE), os.path.join(d, "fx.nii.gz"))
    nifti_mod.save(nifti_mod.NiftiImage(mov, AFFINE), os.path.join(d, "mov.nii.gz"))


def _outputs(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jcfg = JaxVxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in ARCH.items()})
    path = str(tmp_path_factory.mktemp("ckpt") / "w.npz")
    np.savez(path, **random_flat_params(jcfg, seed=4))
    return path


def _run_both(tmp_path, checkpoint, warp_interpolation):
    settings = dict(ARCH, warp_interpolation=warp_interpolation)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _write_inputs(jd, jnifti)
    _write_inputs(td, tnifti)

    jcfg = jconf.InferenceConfig.from_dict(dict(settings))
    jr = jreg.Registrar(jcfg, jreg.load_params_any(checkpoint, jcfg))
    jout = jreg.register(jcfg, jr, os.path.join(jd, "fx.nii.gz"), os.path.join(jd, "mov.nii.gz"),
                         fx_contrast="T2w", naming="standalone", res_dir=os.path.join(jd, "res"))

    tcfg = tconf.InferenceConfig.from_dict(dict(settings))
    tr = treg.Registrar(tcfg, treg.load_params_any(checkpoint, tcfg), device="cpu")
    tout = treg.register(tcfg, tr, os.path.join(td, "fx.nii.gz"), os.path.join(td, "mov.nii.gz"),
                         fx_contrast="T2w", naming="standalone", res_dir=os.path.join(td, "res"))
    return jd, td, jout, tout


def test_register_writes_the_jax_packages_files(tmp_path, checkpoint):
    jd, td, jout, tout = _run_both(tmp_path, checkpoint, "linear")
    names = _outputs(jd)
    assert names == _outputs(td)
    assert set(names) == {"fx.nii.gz", "mov.nii.gz", "fx_proc.nii.gz", "mov_proc.nii.gz",
                          "mov_proc_reg_to_T2w.nii.gz", "mov_proc_field_to_T2w.nii.gz",
                          os.path.join("res", "warped_im.nii.gz"),
                          os.path.join("res", "deform_field.nii.gz")}
    assert set(tout["timings"]) == set(jout["timings"])
    assert np.abs(jout["warp_data"]).max() > 0.5  # a real field, not the identity
    for name in names:
        a = jnifti.load(os.path.join(jd, name))
        b = tnifti.load(os.path.join(td, name))
        for f in HEADER_FIELDS:
            np.testing.assert_array_equal(np.asarray(b.header[f]), np.asarray(a.header[f]),
                                          err_msg=f"{name}: {f}")
        np.testing.assert_array_equal(b.affine, a.affine, err_msg=name)
        assert b.dataobj.dtype == a.dataobj.dtype, name
        if "field" in name:
            tol = bf16_ulp(np.abs(a.get_fdata()).max())
        elif "reg_to" in name or "warped" in name:
            tol = 1e-3
        else:
            tol = 0.0
        np.testing.assert_allclose(b.get_fdata(), a.get_fdata(), atol=tol, rtol=0,
                                   err_msg=name)
    field = tnifti.load(os.path.join(td, "res", "deform_field.nii.gz"))
    assert field.header["intent_code"] == 1007
    assert field.shape == (*SHAPE, 1, 3)
    assert tnifti.load(os.path.join(td, "mov_proc_field_to_T2w.nii.gz")).header["intent_code"] == 1007


def test_register_nearest_warp(tmp_path, checkpoint):
    jd, td, jout, tout = _run_both(tmp_path, checkpoint, "nearest")
    np.testing.assert_allclose(tout["warp_data"], jout["warp_data"], rtol=0,
                               atol=bf16_ulp(np.abs(jout["warp_data"]).max()))
    a = jnifti.load(os.path.join(jd, "res", "warped_im.nii.gz")).get_fdata()
    b = tnifti.load(os.path.join(td, "res", "warped_im.nii.gz")).get_fdata()
    differ = a != b
    assert differ.mean() <= 1e-3, differ.mean()
    # nearest only picks input values: every output voxel is one of the moving
    # image's (processed) values
    mov_proc = tnifti.load(os.path.join(td, "mov_proc.nii.gz")).get_fdata()
    assert np.isin(b.astype(np.float32), mov_proc.astype(np.float32)).all()
