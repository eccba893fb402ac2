"""Port the Keras ``.h5`` import (``models/h5_import.py``) against the JAX
package's: a tiny Keras-layout file written with h5py (one Conv3D layer per
conv in module order, then the flow head) imports to the state dict that
``params_from_jax`` makes of the JAX import: equal. Also through
``load_params_any`` and ``Trainer.load_checkpoint``, a layer without a bias
(zero, as the JAX package's zero template gives), and the refusals."""

import sys

import pytest
import torch

pytest.importorskip("h5py")

from multimodal_registration_tpu.models.h5_import import conv_module_order as jax_order
from multimodal_registration_tpu.models.h5_import import import_keras_vxm_h5 as jax_import
from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.models.vxm_dense import params_template
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.models import h5_import as th5
from multimodal_registration_torch.models.vxm_dense import VxmConfig
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.train import trainer as ttr
from multimodal_registration_torch.train.config import TrainConfig

from _torch_port import random_flat_params, tiny_train_cfg, write_keras_h5

ARCHS = {"flagship-like": ((4,) * 4, (4,) * 6), "one-final": ((4, 6, 6, 8), (8, 6, 6, 4, 5))}


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("with_bias", [True, False])
def test_import_equals_jax(tmp_path, arch, with_bias):
    enc, dec = ARCHS[arch]
    jcfg, tcfg = JaxVxmConfig(enc=enc, dec=dec), VxmConfig(enc=enc, dec=dec)
    flat = random_flat_params(jcfg, seed=3)
    path = str(tmp_path / "model.h5")
    write_keras_h5(path, flat, with_bias=with_bias)
    want = params_from_jax(jax_import(path, params_template(jcfg), jcfg), tcfg)
    got = th5.import_keras_vxm_h5(path, tcfg)
    _assert_equal(got, want)
    if not with_bias:
        assert all(float(v.abs().max()) == 0 for k, v in got.items() if k.endswith(".bias"))
    assert th5.conv_module_order(tcfg) == jax_order(jcfg)


def test_load_params_any_and_trainer_read_h5(tmp_path):
    arch = dict(enc=[4] * 4, dec=[4] * 6, compute_dtype="float32")
    cfg = tconf.InferenceConfig.from_dict(dict(arch))
    jcfg = JaxVxmConfig(enc=(4,) * 4, dec=(4,) * 6)
    flat = random_flat_params(jcfg, seed=5)
    path = str(tmp_path / "model.hdf5")
    write_keras_h5(path, flat)
    want = params_from_jax(flat, VxmConfig(enc=(4,) * 4, dec=(4,) * 6))
    _assert_equal(treg.load_params_any(path, cfg), want)

    trainer = ttr.Trainer(TrainConfig.from_dict(tiny_train_cfg(tmp_path)), device="cpu")
    assert trainer.load_checkpoint(path) == 0
    _assert_equal({k: v for k, v in trainer.model.state_dict().items()}, want)


def test_refusals(tmp_path, monkeypatch):
    jcfg = JaxVxmConfig(enc=(4,) * 4, dec=(4,) * 6)
    flat = random_flat_params(jcfg, seed=6)
    path = str(tmp_path / "model.h5")
    write_keras_h5(path, flat)
    # a config with another width: the shape check names the layer
    cfg = tconf.InferenceConfig.from_dict(dict(enc=[8] * 4, dec=[8] * 6))
    with pytest.raises(ValueError, match="does not match the config's architecture"):
        treg.load_params_any(path, cfg)
    with pytest.raises(ValueError, match="kernel shape mismatch"):
        th5.import_keras_vxm_h5(path, VxmConfig(enc=(8,) * 4, dec=(8,) * 6))
    # another depth: the layer count
    with pytest.raises(ValueError, match="Conv3D layers"):
        th5.import_keras_vxm_h5(path, VxmConfig(enc=(4,) * 4, dec=(4,) * 5))
    # without h5py the reader says what is missing
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs the h5py package"):
        th5.import_keras_vxm_h5(path, VxmConfig(enc=(4,) * 4, dec=(4,) * 6))
