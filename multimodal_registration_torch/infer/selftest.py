"""Consistency checks of the sharded inference surface: the port's copy of
``multimodal_registration_tpu/infer/selftest.py``.

Each drives the port's entry points twice, on one device and sharded over
``space`` devices, and asserts matching outputs (raises ``AssertionError``
otherwise). ``device`` is what the CLIs' ``--device`` takes
(``parallel/mesh.py::mesh_devices``): ``"cpu"`` repeats the CPU, and a list
such as ``"cuda:0,cuda:0"`` names the mesh's devices; the unsharded run uses
the first of them. Shared by ``tools/dryrun_multichip.py`` and the tests.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import Registrar, vxm_config_from
from multimodal_registration_torch.infer.sharded import ShardedRegistrar
from multimodal_registration_torch.models.vxm_dense import VxmDense
from multimodal_registration_torch.models.weights import params_to_jax
from multimodal_registration_torch.parallel.mesh import first_device, make_mesh, mesh_devices
from multimodal_registration_torch.utils import nifti

TINY = dict(enc=[4] * 4, dec=[4] * 6, compute_dtype="float32")


def _random_weights(cfg: dict, rng, scale: float = 0.05, biases: bool = True) -> dict:
    """A state dict of the config's model, every entry drawn from
    ``rng`` (biases left at zero unless ``biases``)."""
    shapes = VxmDense(vxm_config_from(InferenceConfig.from_dict(cfg)), device="meta").state_dict()
    return {k: torch.zeros(v.shape) if v.ndim == 1 and not biases else
            torch.as_tensor(rng.normal(scale=scale, size=v.shape).astype(np.float32))
            for k, v in shapes.items()}


def _write_pair(d: str, fx: np.ndarray, mov: np.ndarray) -> tuple:
    os.makedirs(d, exist_ok=True)
    paths = os.path.join(d, "fx.nii.gz"), os.path.join(d, "mov.nii.gz")
    for p, data in zip(paths, (fx, mov)):
        nifti.save(nifti.NiftiImage(data, np.eye(4)), p)
    return paths


def cli_space_parity_check(space: int, workdir: str, seed: int = 0, atol: float = 2e-4,
                           device="cpu") -> None:
    """Drive ``pair_registration`` unsharded and with ``--space`` on a
    synthetic pair (X = 32 * space) and assert the NIfTI outputs agree."""
    from multimodal_registration_torch.infer.cli import pair_registration

    rng = np.random.default_rng(seed)
    shape = (32 * space, 16, 16)
    fx_p, mov_p = _write_pair(workdir, rng.random(shape).astype(np.float32),
                              rng.random(shape).astype(np.float32))
    wpath = os.path.join(workdir, "w.npz")
    np.savez(wpath, **params_to_jax(_random_weights(TINY, rng)))
    cfg_p = os.path.join(workdir, "cfg.json")
    with open(cfg_p, "w") as f:
        json.dump(TINY, f)

    outs = {}
    for tag, extra in (("single", ["--device", str(first_device(device))]),
                       ("sharded", ["--space", str(space), "--device", str(device)])):
        res_dir = os.path.join(workdir, f"res_{tag}")
        pair_registration([
            "--model-path", wpath, "--config-path", cfg_p, "--fx-img-path", fx_p,
            "--mov-img-path", mov_p, "--fx-img-contrast", "T2w", "--res-dir", res_dir,
            "--one-cpu-tf", "False", *extra])
        outs[tag] = [nifti.load(os.path.join(res_dir, n)).get_fdata()
                     for n in ("warped_im.nii.gz", "deform_field.nii.gz")]
    np.testing.assert_allclose(outs["sharded"][0], outs["single"][0], atol=atol,
                               err_msg="sharded CLI moved != single-device")
    np.testing.assert_allclose(outs["sharded"][1], outs["single"][1], atol=atol,
                               err_msg="sharded CLI field != single-device")


def cli_cascade_space_parity_check(space: int, workdir: str, seed: int = 0,
                                   atol: float = 2e-4, device="cpu") -> None:
    """Drive the two-step cascade CLI (``bids_two_steps``, two different
    models) unsharded and with ``--space`` and assert matching outputs: two
    sharded registrars, the composition on the first device, the shared
    postprocessing."""
    from multimodal_registration_torch.infer.cli import bids_two_steps

    rng = np.random.default_rng(seed)
    shape = (32 * space, 16, 16)
    fx_data = rng.random(shape).astype(np.float32)
    mov_data = rng.random(shape).astype(np.float32)
    wpaths = []
    for i in range(2):
        wpaths.append(os.path.join(workdir, f"w{i + 1}.npz"))
        np.savez(wpaths[-1], **params_to_jax(_random_weights(TINY, rng)))

    outs = {}
    cwd = os.getcwd()
    try:
        for tag, extra in (("single", ["--device", str(first_device(device))]),
                           ("sharded", ["--space", str(space), "--device", str(device)])):
            d = os.path.join(workdir, f"casc_{tag}")
            fx_p, mov_p = _write_pair(d, fx_data, mov_data)
            cfg_p = os.path.join(d, "cfg.json")
            with open(cfg_p, "w") as f:
                json.dump(TINY, f)
            os.chdir(d)
            bids_two_steps([
                "--model1-path", wpaths[0], "--model2-path", wpaths[1], "--config-path", cfg_p,
                "--fx-img-path", fx_p, "--mov-img-path", mov_p, "--fx-img-contrast", "T2w",
                "--one-cpu-tf", "False", *extra])
            os.chdir(cwd)
            outs[tag] = [nifti.load(os.path.join(d, n)).get_fdata()
                         for n in ("mov_reg_original_dim.nii.gz", "mov_warp_original_dim.nii.gz")]
    finally:
        os.chdir(cwd)
    np.testing.assert_allclose(outs["sharded"][0], outs["single"][0], atol=atol,
                               err_msg="sharded cascade moved != single-device")
    np.testing.assert_allclose(outs["sharded"][1], outs["single"][1], atol=atol,
                               err_msg="sharded cascade field != single-device")


def int8_sharded_forward_check(space: int, atol: float = 2e-5, device="cpu") -> None:
    """The int8 forward (enc [64]x2, dec [64]x4, lazily calibrated: over the
    slabs on the mesh, over the whole volume on one device) space-sharded
    against one device on random input: the int32 sums are exact, so the
    outputs agree to ``atol``."""
    arch = dict(enc=[64, 64], dec=[64] * 4, int_steps=3, compute_dtype="float32")
    cfg = InferenceConfig.from_dict(dict(arch, quantize="int8"))
    rng = np.random.default_rng(13)
    params = _random_weights(arch, rng, scale=0.02, biases=False)
    mov = rng.random((1, 16 * space, 16, 16), dtype=np.float64).astype(np.float32)
    fx = rng.random((1, 16 * space, 16, 16), dtype=np.float64).astype(np.float32)

    sharded = ShardedRegistrar(cfg, params,
                               make_mesh(space, space=space, devices=mesh_devices(device, space)))
    m1, w1 = sharded.predict(mov, fx)
    m2, w2 = Registrar(cfg, params, device=str(first_device(device))).predict(mov, fx)
    np.testing.assert_allclose(w1, w2, atol=atol,
                               err_msg="int8 space-sharded field != single-device field")
    np.testing.assert_allclose(m1, m2, atol=atol,
                               err_msg="int8 space-sharded moved != single-device moved")
