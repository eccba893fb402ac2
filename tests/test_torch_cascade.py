"""Port the two-step cascade (``infer/cascade.py``) and the BIDS CLIs
(``infer/cli.py``) against the JAX package's.

Every branch of ``register_two_steps``: the whole volume with linear warping
(final field composed on the image grid, ``cascade_compose_res`` 'full') and
with nearest warping (composed at the field's resolution, 'int'); subvolumes
with linear warping under 'full' (blend, then compose) and 'int' (compose
tile by tile, then blend); subvolumes with nearest warping (blend, warp,
preprocess again, second tiling, compose). The first model runs with the
config's ``model1_svf_smooth_sigma`` (3 voxels), the second without. The
pair is off the fixed grid, as in ``test_torch_subvol.py``.

Tolerances by ``assert_same_outputs``: fields within 1 bf16 ulp of their
magnitude (fault F2), moved intensities within that or 1e-3, nearest-warped
images in all but 0.1% of their voxels."""

import contextlib
import importlib
import io
import json
import re

import numpy as np
import pytest
import torch

from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_torch.infer import cascade as tcas
from multimodal_registration_torch.infer import cli as tcli
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import (assert_same_outputs, bf16_ulp, output_files, random_flat_params,
                         scan_affine, write_scan_pair)

jreg = importlib.import_module("multimodal_registration_tpu.infer.register")
jcas = importlib.import_module("multimodal_registration_tpu.infer.cascade")
jcli = importlib.import_module("multimodal_registration_tpu.infer.cli")

ARCH = dict(enc=[8] * 4, dec=[8] * 6, int_steps=5, int_res=2, svf_res=2,
            compute_dtype="float32")
SUBVOL = dict(use_subvol=True, subvol_size=[32, 32, 32], min_perc_overlap=0.2)
FIXED = ((48, 48, 48), (1.0, 1.0, 1.0))
MOVING = ((40, 40, 32), (1.2, 1.2, 1.5))
BRANCHES = {
    "whole-linear-full": dict(warp_interpolation="linear", cascade_compose_res="full"),
    "whole-nearest-int": dict(warp_interpolation="nearest", cascade_compose_res="int"),
    "subvol-linear-full": dict(SUBVOL, warp_interpolation="linear", cascade_compose_res="full"),
    "subvol-linear-int": dict(SUBVOL, warp_interpolation="linear", cascade_compose_res="int"),
    "subvol-nearest-full": dict(SUBVOL, warp_interpolation="nearest"),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    jcfg = JaxVxmConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in ARCH.items()})
    d = tmp_path_factory.mktemp("ckpt")
    paths = []
    for i, seed in enumerate((21, 22)):
        paths.append(str(d / f"model{i + 1}.npz"))
        np.savez(paths[-1], **random_flat_params(jcfg, seed=seed))
    return paths


@pytest.fixture(scope="module")
def registrars(checkpoints):
    """Both packages' two registrars, shared by the branches (the JAX ones
    compile once per shape)."""
    jc, tc = jconf.InferenceConfig.from_dict(dict(ARCH)), tconf.InferenceConfig.from_dict(dict(ARCH))
    sigma = jc.model1_svf_smooth_sigma
    assert sigma == tc.model1_svf_smooth_sigma == 3.0
    m1, m2 = checkpoints
    jax_regs = (jreg.Registrar(jc, jreg.load_params_any(m1, jc), max_batch=3,
                               svf_smooth_sigma=sigma),
                jreg.Registrar(jc, jreg.load_params_any(m2, jc), max_batch=3))
    port_regs = (treg.Registrar(tc, treg.load_params_any(m1, tc), max_batch=3, device="cpu",
                                svf_smooth_sigma=sigma),
                 treg.Registrar(tc, treg.load_params_any(m2, tc), max_batch=3, device="cpu"))
    assert port_regs[0].vxm_cfg.svf_smooth_sigma == 3.0
    assert port_regs[1].vxm_cfg.svf_smooth_sigma == 0.0
    return jax_regs, port_regs


def _pair(d, nifti_mod):
    write_scan_pair(str(d), nifti_mod, (FIXED[0], scan_affine(*FIXED)),
                    (MOVING[0], scan_affine(*MOVING)))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cascade_matches_jax(tmp_path, registrars, branch):
    settings = dict(ARCH, **BRANCHES[branch])
    outs = []
    for d, nifti_mod, conf, cas, regs in (
            (tmp_path / "jax", jnifti, jconf, jcas, registrars[0]),
            (tmp_path / "port", tnifti, tconf, tcas, registrars[1])):
        _pair(d, nifti_mod)
        cfg = conf.InferenceConfig.from_dict(dict(settings))
        outs.append(cas.register_two_steps(cfg, *regs, str(d / "fx.nii.gz"),
                                           str(d / "mov.nii.gz"), fx_contrast="T2w"))
    jout, tout = outs
    assert tout["scale"] == jout["scale"]
    assert np.abs(jout["warp_data"]).max() > 0.2  # a real field, not the identity
    np.testing.assert_allclose(tout["warp_data"], jout["warp_data"], rtol=0,
                               atol=bf16_ulp(np.abs(jout["warp_data"]).max()))
    names = assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"),
                                nearest="nearest" in branch)
    assert "mov_warp_original_dim.nii.gz" in names
    if branch == "subvol-nearest-full":  # the first step's outputs of the second tiling
        assert "mov_proc_first_reg_to_T2w.nii.gz" in names


def _options(fn):
    """The option strings of a CLI, read from its ``--help``."""
    return set(re.findall(r"(--[a-z0-9-]+)", _help_text(fn)))


@pytest.mark.parametrize("name", ["pair_registration", "bids_registration", "bids_two_steps",
                                  "gen_apply_def_field"])
def test_cli_flags_are_the_jax_packages(name):
    """The JAX package's flags, the sharding ones among them, plus --device."""
    want = _options(getattr(jcli, name))
    assert _options(getattr(tcli, name)) == want | {"--device"}


def test_bids_clis_match_the_functions(tmp_path, checkpoints):
    """``bids_registration`` and ``bids_two_steps`` through their argv with
    ``--device cpu`` write what the functions write (the JAX CLIs, in the
    same layout, too)."""
    m1, m2 = checkpoints
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(ARCH))
    for which in ("bids_registration", "bids_two_steps"):
        models = (["--model-path", m2] if which == "bids_registration"
                  else ["--model1-path", m1, "--model2-path", m2])
        for pkg, nifti_mod in (("jax", jnifti), ("port", tnifti)):
            d = tmp_path / which / pkg
            _pair(d, nifti_mod)
            argv = models + ["--config-path", str(cfg_path), "--fx-img-path", str(d / "fx.nii.gz"),
                             "--mov-img-path", str(d / "mov.nii.gz"), "--fx-img-contrast", "T2w",
                             "--one-cpu-tf", "False"]
            if pkg == "jax":
                getattr(jcli, which)(argv)
            else:
                out = getattr(tcli, which)(argv + ["--device", "cpu"])
                assert out["paths"]["warp_orig"].endswith("mov_warp_original_dim.nii.gz")
        assert set(output_files(str(tmp_path / which / "port"))) >= {
            "mov_reg_original_dim.nii.gz", "mov_warp_original_dim.nii.gz",
            "mov_proc_field_to_T2w.nii.gz", "mov_proc_reg_to_T2w.nii.gz"}
        assert_same_outputs(str(tmp_path / which / "jax"), str(tmp_path / which / "port"))


def test_gen_apply_def_field_and_the_command_line(tmp_path, capsys):
    """``gen_apply_def_field`` draws its field with a seeded torch.Generator
    (the same seed, the same field; not the JAX package's field, whose
    random number generator differs) and writes the field and the volume
    warped by it; ``python -m multimodal_registration_torch <command>``
    reaches every CLI."""
    from multimodal_registration_torch.__main__ import COMMANDS, main
    from multimodal_registration_torch.ops.warp import warp

    vol = np.random.default_rng(0).random((24, 20, 16)).astype(np.float32)
    tnifti.save(tnifti.NiftiImage(vol, np.eye(4)), str(tmp_path / "im.nii.gz"))
    fields = []
    for run in ("a", "b"):
        argv = ["gen-apply-def-field", "--im-path", str(tmp_path / "im.nii.gz"), "--res-dir",
                str(tmp_path / run), "--def-scales", "8", "16", "--seed", "5", "--device", "cpu"]
        assert main(argv) == 0
        field = tnifti.load(str(tmp_path / run / "deformation_field.nii.gz")).get_fdata()
        moved = tnifti.load(str(tmp_path / run / "moved_im.nii.gz")).get_fdata()
        assert field.shape == (24, 20, 16, 3) and 0.1 < np.abs(field).max() < 20
        want = warp(torch.as_tensor(vol), torch.as_tensor(field.astype(np.float32)))
        np.testing.assert_allclose(moved, want.numpy(), atol=1e-6, rtol=0)
        fields.append(field)
    np.testing.assert_array_equal(fields[0], fields[1])
    assert "not the jax package's field" in " ".join(
        _help_text(tcli.gen_apply_def_field).lower().split())

    assert main([]) == 2 and main(["--help"]) == 0
    assert set(COMMANDS) == {"bids-registration", "bids-two-steps", "gen-apply-def-field",
                             "quant-calibrate", "eval-on-sc-seg", "eval-with-mi",
                             "eval-with-jacobian", "pipeline"}
    capsys.readouterr()


def _help_text(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        fn(["--help"])
    return buf.getvalue()
