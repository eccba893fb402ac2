"""The port stands alone and fails loudly.

  * no module of ``multimodal_registration_torch`` and not ``chip_smoke.py``
    imports JAX or anything of the JAX package (an AST scan);
  * an entry point given no ``device`` runs on the GPU, and without one it
    raises instead of running on the CPU;
  * every setting the port does not run yet raises ``NotImplementedError``
    naming its ROADMAP item, and those it has ported since run;
  * ``chip_smoke.py`` without a GPU, or without the rest of the repo, exits
    non-zero and prints no result line.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_registration_torch import device as tdevice
from multimodal_registration_torch.infer import cli as tcli
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import preprocess as tpre
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.models import vxm_dense as tvd
from multimodal_registration_torch.models.weights import params_to_jax
from multimodal_registration_torch.ops import resample as tres
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import synthetic_pair, write_keras_h5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "multimodal_registration_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodal_registration_tpu")
TINY = dict(enc=[4] * 4, dec=[4] * 6)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_port_imports_nothing_of_jax():
    files = _port_sources()
    assert len(files) > 15, files
    for new in ("ops/conv_int8.py", "models/quantize.py"):  # the int8 route is scanned too
        assert os.path.join(PKG, new) in files, new
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_params(cfg):
    model = tvd.VxmDense(treg.vxm_config_from(cfg), device="cpu")
    return model.state_dict()


def test_entry_points_default_to_the_gpu_and_raise_without_one(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")

    cfg = tconf.InferenceConfig.from_dict(dict(TINY))
    params = _tiny_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.Registrar(cfg, params)
    vol = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treg.apply_warp(vol, np.zeros((8, 8, 8, 3), np.float32), "linear")
    with pytest.raises(RuntimeError, match="no CUDA device"):  # a non-identity grid map
        tres.affine_resample(vol, np.eye(4), np.diag([0.5, 1, 1, 1]), (16, 8, 8), "linear")

    # the pair CLI: no --device means the GPU
    fx, mov = synthetic_pair((16, 16, 16))
    for name, data in (("fx", fx), ("mov", mov)):
        tnifti.save(tnifti.NiftiImage(data, np.eye(4)), str(tmp_path / f"{name}.nii.gz"))
    np.savez(tmp_path / "w.npz", **params_to_jax(params))
    (tmp_path / "cfg.json").write_text(json.dumps(dict(TINY, compute_dtype="float32")))
    argv = ["--model-path", str(tmp_path / "w.npz"), "--config-path", str(tmp_path / "cfg.json"),
            "--fx-img-path", str(tmp_path / "fx.nii.gz"),
            "--mov-img-path", str(tmp_path / "mov.nii.gz"), "--res-dir", str(tmp_path / "res"),
            "--one-cpu-tf", "False"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.pair_registration(argv)
    # and with --device cpu it runs and writes the 3d_reg outputs
    out = tcli.pair_registration(argv + ["--device", "cpu"])
    assert out["warp"].shape == (16, 16, 16, 1, 3)
    assert (tmp_path / "res" / "warped_im.nii.gz").exists()
    assert tnifti.load(str(tmp_path / "res" / "deform_field.nii.gz")).header["intent_code"] == 1007


def test_settings_not_ported_yet_raise(tmp_path):
    # svf_smooth_sigma is ported (item 5): the model builds
    assert tvd.VxmDense(tvd.VxmConfig(enc=(4,) * 4, dec=(4,) * 6, svf_smooth_sigma=1.0),
                        device="cpu").cfg.svf_smooth_sigma == 1.0
    # item 12's int8 inference is ported: the model builds and the config loads
    assert tvd.VxmDense(tvd.VxmConfig(quantize="int8"), device="meta").quant_blocks()
    assert tconf.InferenceConfig.from_dict(dict(TINY, quantize="int8")).quantize == "int8"
    with pytest.raises(NotImplementedError, match="item 15"):
        tconf.InferenceConfig.from_dict(dict(TINY, sharding={"data": 2}))
    # parsed and validated as in the JAX package before that
    with pytest.raises(ValueError, match="quantize"):
        tconf.InferenceConfig.from_dict(dict(TINY, quantize="int4"))
    with pytest.raises(ValueError, match="sharding"):
        tconf.InferenceConfig.from_dict(dict(TINY, sharding={"model": 2}))
    with pytest.raises(ValueError, match="positive integer"):
        tconf.InferenceConfig.from_dict(dict(TINY, sharding={"data": 0}))
    assert tconf.InferenceConfig.from_dict(dict(TINY, sharding={"data": 1})).round16(40) == 32

    cfg = tconf.InferenceConfig.from_dict(dict(TINY))
    params = _tiny_params(cfg)
    # item 9c's Keras .h5 import is ported: the weights come back
    write_keras_h5(str(tmp_path / "w.h5"), params_to_jax(params))
    loaded = treg.load_params_any(str(tmp_path / "w.h5"), cfg)
    assert all(torch.equal(loaded[k], v) for k, v in params.items())
    with pytest.raises(NotImplementedError, match="Orbax"):
        treg.load_params_any(str(tmp_path / "ckpt_dir"), cfg)
    # item 10's spline on a non-identity grid map is ported: it runs
    out = tres.affine_resample(np.ones((8, 8, 8)), np.eye(4), np.diag([0.5, 1, 1, 1]),
                               (16, 8, 8), "spline", device="cpu")
    assert out.shape == (16, 8, 8) and np.allclose(out[:15], 1.0)

    # item 9b's subvolume tiling and blending is ported: register() runs
    sub = tconf.InferenceConfig.from_dict(dict(TINY, use_subvol=True, subvol_size=[16, 16, 16]))
    reg = treg.Registrar(cfg, params, device="cpu")
    fx, mov = synthetic_pair((32, 32, 32))
    for name, data in (("fx", fx), ("mov", mov)):
        tnifti.save(tnifti.NiftiImage(data, np.eye(4)), str(tmp_path / f"{name}.nii.gz"))
    res = treg.register(sub, reg, str(tmp_path / "fx.nii.gz"), str(tmp_path / "mov.nii.gz"))
    assert res["warp"].shape == (32, 32, 32, 1, 3)
    # the tile grid refuses tiles larger than the volume
    with pytest.raises(ValueError, match="subvol_size"):
        tpre.subvol_grid(sub, (64, 64, 8))


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    for cwd in (ROOT, str(tmp_path)):
        r = _run_smoke(cwd)
        assert r.returncode != 0, (cwd, r.stdout[-2000:])
        assert '"ok": true' not in r.stdout
