"""The port's data-parallel training (``Trainer`` over a mesh's ``data``
axis, ``train/trainer.py``) on the CPU.

(a) An n-replica step equals the 1-device step on the same generator, maps
and initial parameters, to the JAX package's tolerances
(``__graft_entry__.py::dryrun_multichip``): loss within ``1e-5 +
1e-5 |loss|``, every parameter within rtol 1e-4 / atol 2e-5. The mesh names
``cpu`` and ``cpu:0``: two devices to the trainer, so the second replica is
a copy of the model whose parameters are copied in before the step and
whose gradients are summed into the first's, as on a second card.
(b) The 2-replica gradients of a fixed batch (the JAX package's synthesis)
against JAX's ``value_and_grad`` of the whole batch, to
``test_torch_train.py``'s tolerances (loss 1e-5, every gradient within 2e-5
of its leaf's largest entry).
(c) ``run_training`` with ``num_devices`` 2, and its checkpoint loaded by a
1-device ``Trainer``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.train import trainer as jtr
from multimodal_registration_tpu.train.config import TrainConfig as JTrainConfig
from multimodal_registration_torch.models.weights import grads_to_jax, params_from_jax
from multimodal_registration_torch.parallel.mesh import make_mesh
from multimodal_registration_torch.train import trainer as ttr
from multimodal_registration_torch.train.cli import run_training
from multimodal_registration_torch.train.config import TrainConfig

from _torch_port import label_maps, random_flat_params
from _torch_port import tiny_train_cfg as tiny
from test_torch_train import jax_synthesize

TWO = ["cpu", "cpu:0"]  # two devices of the CPU: the replicas hold their own models


@pytest.fixture(autouse=True)
def jax_production_sampler(monkeypatch):
    monkeypatch.setenv("MMREG_WARP_MODE", "packed")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(cfg, mesh, maps, banked=False):
    trainer = ttr.Trainer(cfg, mesh=mesh)
    trainer.init_state(seed=7)
    gen = trainer.generator(123)
    if banked:
        bank = trainer.put_bank(maps)
        si, ti = trainer.put_indices(np.arange(len(maps)), np.arange(len(maps))[::-1].copy())
        aux = trainer.train_step_banked(gen, bank, si, ti)
        val = trainer.val_step_banked(gen, bank, si[:1], ti[:1])  # batch 1: the first device
    else:
        src, trg = trainer.put_batch(maps, maps[::-1].copy())
        aux = trainer.train_step(gen, src, trg)
        val = trainer.val_step(gen, src, trg)
    params = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    return trainer, float(aux["loss"]), params, {k: float(v) for k, v in val.items()}


@pytest.mark.parametrize("replicas,batch,overrides,banked", [
    (2, 2, {}, False),
    (4, 4, {"grad_clip_norm": 1.0}, False),
    (2, 4, {"zero_borders_maps": True, "zero_borders_maps_val": True}, True),
])
def test_dp_step_equals_single_device_step(tmp_path, replicas, batch, overrides, banked):
    cfg = TrainConfig.from_dict(tiny(tmp_path, batch_size=batch, num_devices=replicas,
                                     **overrides))
    maps = label_maps(batch)
    devices = (TWO * replicas)[:replicas]
    dp, loss, params, val = _step(cfg, make_mesh(replicas, devices=devices), maps, banked)
    assert dp.mesh.shape == {"data": replicas, "space": 1} and len(dp.models) == 2
    _, loss1, params1, val1 = _step(cfg, make_mesh(1, devices=["cpu"]), maps, banked)
    assert np.isfinite(loss)
    assert abs(loss - loss1) <= 1e-5 + 1e-5 * abs(loss1), (loss, loss1)
    for k, v in params1.items():
        torch.testing.assert_close(params[k], v, rtol=1e-4, atol=2e-5, msg=k)
    for k in val1:
        assert abs(val[k] - val1[k]) <= 1e-5 + 1e-5 * abs(val1[k]), (k, val, val1)


def test_dp_gradients_of_a_fixed_batch_equal_jax(tmp_path):
    kw = tiny(tmp_path, compose_payload_dtype="", num_devices=2)
    jcfg, tcfg = JTrainConfig.from_dict(dict(kw)), TrainConfig.from_dict(dict(kw))
    jvcfg = dataclasses.replace(jtr.vxm_config_from(jcfg), integrate_payload_dtype="")
    jecfg = dataclasses.replace(jtr.engine_config_from(jcfg), integrate_payload_dtype="")
    flat = random_flat_params(jvcfg, 31, flow_scale=0.02)
    params = jtr._unflatten_params(jvd.params_template(jvcfg), flat)
    maps = label_maps(4)
    src, trg = maps[:2], maps[2:]
    key = jax.random.PRNGKey(17)
    loss_fn = jtr.make_loss_fn(jvd.VxmDense(cfg=jvcfg), jecfg, jcfg, False)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, key, jnp.asarray(src), jnp.asarray(trg))
    jgrads = jtr._flatten_params(jgrads)

    trainer = ttr.Trainer(tcfg, device=TWO)
    for m in trainer.models.values():
        m.payload_dtype = None
    trainer.engine_cfg = dataclasses.replace(trainer.engine_cfg, integrate_payload_dtype="")
    trainer.model.load_state_dict(params_from_jax(flat, trainer.vxm_cfg))
    batch = jax_synthesize(key, src, trg, jecfg)
    trainer.optimizer.zero_grad()
    shares = [(trainer.models[dev], {k: None if v is None else v[r:r + 1].to(dev)
                                     for k, v in batch.items()}, 0.5)
              for r, dev in enumerate(trainer.replicas)]
    aux = trainer.losses(shares, backward=True)
    np.testing.assert_allclose(float(aux["loss"]), float(jloss), atol=1e-5, rtol=1e-5)
    assert all(p.grad is None for p in trainer.models[torch.device("cpu", 0)].parameters())
    grads = grads_to_jax(trainer.model)
    assert set(grads) == set(jgrads) and len(grads) == 22
    for name, want in jgrads.items():
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(grads[name], want, rtol=0, atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_run_training_on_two_replicas_and_its_checkpoint(tmp_path):
    cfg = TrainConfig.from_dict(tiny(tmp_path, num_devices=2, epochs=2, num_maps=6))
    out = run_training(cfg, max_steps=3, device="cpu")
    trainer = out["trainer"]
    assert trainer.mesh.shape["data"] == 2 and out["steps"] == 3
    rows = open(os.path.join(cfg.log_dir, "metrics.csv")).read().splitlines()
    assert rows[0].startswith("epoch,loss") and len(rows) == 3
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r.split(","))
    with pytest.raises(ValueError, match="not a multiple"):
        run_training(TrainConfig.from_dict(tiny(tmp_path, num_devices=3)), max_steps=1,
                     device="cpu")

    # a checkpoint of the 2-replica trainer loads into a 1-device trainer
    # and has the 1-device checkpoint's keys, shapes and dtypes
    dp = ttr.Trainer(TrainConfig.from_dict(tiny(tmp_path, num_devices=2)), device=TWO)
    maps = label_maps(2)
    dp.train_step(dp.generator(5), *dp.put_batch(maps, maps.copy()))
    dp.save_checkpoint(str(tmp_path / "ck" / "dp"), epoch=1)
    one = ttr.Trainer(TrainConfig.from_dict(tiny(tmp_path)), device="cpu")
    one.save_checkpoint(str(tmp_path / "ck" / "one"))
    with np.load(tmp_path / "ck" / "dp.npz") as a, np.load(tmp_path / "ck" / "one.npz") as b:
        assert sorted(a) == sorted(b)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)
    assert one.load_checkpoint(str(tmp_path / "ck" / "dp"), with_opt=True) == 1
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, dp.model.state_dict()[k]), k
