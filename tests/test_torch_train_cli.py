"""The port's training entry points on the CPU: counterparts of the JAX
package's ``tests/test_train.py`` through ``run_training(cfg, device="cpu")``
and ``main``, and checkpoints crossing between the two packages in both
directions (the flat ``.npz`` key format). The loss, gradient and Adam parity
tests are in ``test_torch_train.py``."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.train import trainer as jtr
from multimodal_registration_tpu.train.config import TrainConfig as JTrainConfig
from multimodal_registration_torch.models.weights import params_to_jax
from multimodal_registration_torch.train import trainer as ttr
from multimodal_registration_torch.train.cli import main as train_main
from multimodal_registration_torch.train.cli import run_training
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.utils import nifti as tnifti

from _torch_port import label_maps, write_keras_h5
from _torch_port import tiny_train_cfg as tiny


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many tiny operators: a thread pool per operator only fights the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smoke_train_loss_decreases(tmp_path):
    """Six tiny epochs run and log; the per-epoch mean over two freshly
    synthesised batches is dominated by sampling noise at this size, so
    "decreases" is shown where it is deterministic: Adam steps on one fixed
    batch (the same generator seed each step) bring its loss down."""
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=6))
    out = run_training(cfg, device="cpu")
    hist = out["history"]
    assert len(hist) == 6 and out["steps"] == 12 and len(out["step_seconds"]) == 12
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"]) for h in hist)
    with open(os.path.join(cfg.log_dir, "metrics.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "loss", "dice_loss", "grad_loss", "val_loss", "sec_per_step"]
    assert len(rows) == 7 and rows[-1][0] == "6"

    trainer = ttr.Trainer(TrainConfig.from_dict(tiny(tmp_path, lr=1e-2, same_subj=False)),
                          device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    src, trg = trainer.put_batch(label_maps(2, 1), label_maps(2, 2))
    losses = [float(trainer.train_step(trainer.generator(5), src, trg)["loss"])
              for _ in range(30)]
    assert losses[-1] < losses[0] - 0.02, losses
    assert all(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())


def test_checkpoint_roundtrip(tmp_path):
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=1))
    out = run_training(cfg, device="cpu")
    ckpt = os.path.join(cfg.model_dir, "final")
    for stem in ("0000", "0001", "final"):  # epoch-0 snapshot, save_freq 1, final
        assert os.path.exists(os.path.join(cfg.model_dir, stem + ".npz"))
        assert os.path.exists(os.path.join(cfg.model_dir, stem + ".opt.pt"))
    trainer = ttr.Trainer(cfg, device="cpu")
    assert trainer.load_checkpoint(ckpt, with_opt=True) == cfg.epochs
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, out["params"][k], atol=0, rtol=0)
    # the optimizer's moments came back too
    st = trainer.optimizer.state_dict()["state"]
    assert len(st) == 22 and all(float(s["step"]) == out["steps"] for s in st.values())
    # a Keras .h5 of the same weights loads too (weights only, epoch 0)
    write_keras_h5(str(tmp_path / "model.h5"), params_to_jax(out["params"]))
    assert trainer.load_checkpoint(str(tmp_path / "model.h5")) == 0
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, out["params"][k], atol=0, rtol=0)
    with pytest.raises(FileNotFoundError):
        trainer.load_checkpoint(str(tmp_path / "nothing"))


def test_npz_warm_start(tmp_path):
    """Warm start from the in-repo flagship checkpoint's format: a flat .npz
    written by training, named with its extension as the config does."""
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=1))
    out = run_training(cfg, device="cpu")
    ckpt = os.path.join(cfg.model_dir, "final.npz")
    cfg2 = TrainConfig.from_dict(tiny(tmp_path, epochs=1, bool_init_weights=True,
                                      init_weights=ckpt, model_dir=str(tmp_path / "m2")))
    out2 = run_training(cfg2, device="cpu", max_steps=0)
    assert len(out2["history"]) == 1
    with np.load(os.path.join(cfg2.model_dir, "0000.npz")) as z:  # saved before the fit
        for k, v in params_to_jax(out["params"]).items():
            np.testing.assert_array_equal(z[k], v)


def test_warm_start_from_the_flagship_checkpoint(tmp_path):
    """The in-repo enc-64 checkpoint (written by the JAX trainer) starts a
    run of the port at full width; the epoch-0 snapshot holds its weights."""
    ref = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "learned_ref_160x160x192_26lab.npz")
    cfg = TrainConfig.from_dict(tiny(tmp_path, enc=[64] * 4, dec=[64] * 6, batch_size=1,
                                     bool_init_weights=True, init_weights=ref))
    out = run_training(cfg, device="cpu", max_steps=1)
    assert out["steps"] == 1 and np.isfinite(out["history"][0]["loss"])
    with np.load(ref) as want, np.load(os.path.join(cfg.model_dir, "0000.npz")) as got:
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    moved = params_to_jax(out["params"])
    with np.load(ref) as want:
        assert all(not np.array_equal(moved[k], want[k]) for k in want)


def test_zero_border_training_path(tmp_path):
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=1, zero_borders_maps=True,
                                     zero_bord_frac=1.0, zero_bord_scale=2))
    out = run_training(cfg, device="cpu")
    assert np.isfinite(out["history"][0]["loss"])
    assert np.isfinite(out["history"][0]["dice_loss"])


def test_loaded_noncontiguous_labels_are_remapped(tmp_path):
    lab_dir = tmp_path / "loaded_labels"
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    values = np.array([0, 3, 7, 200], np.uint8)
    for i in range(4):
        m = values[rng.integers(0, 4, size=(16, 16, 16))]
        tnifti.save(tnifti.NiftiImage(m.astype(np.float32), np.eye(4)),
                    str(lab_dir / f"map_{i}.nii.gz"))
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=1, gen_label=False,
                                     label_dir=str(lab_dir), num_labels=26))  # wrong on purpose
    out = run_training(cfg, device="cpu")
    assert cfg.num_labels == 4  # overridden to the actual count
    assert np.isfinite(out["history"][-1]["loss"])


def test_vel_res_list_train_step_runs(tmp_path):
    cfg = TrainConfig.from_dict(tiny(tmp_path, vel_res=[8, 16]))
    trainer = ttr.Trainer(cfg, device="cpu")
    assert trainer.engine_cfg.vel_res == (8.0, 16.0)
    maps = np.random.default_rng(2).integers(0, 4, size=(2, 16, 16, 16), dtype=np.uint8)
    src, trg = trainer.put_batch(maps, maps.copy())
    aux = trainer.train_step(trainer.generator(4), src, trg)
    assert np.isfinite(float(aux["loss"]))
    bank = trainer.put_bank(maps)
    si, ti = trainer.put_indices(np.array([1, 0]), np.array([0, 1]))
    assert np.isfinite(float(trainer.val_step_banked(trainer.generator(4), bank, si, ti)["loss"]))
    assert np.isfinite(float(trainer.train_step_banked(trainer.generator(4), bank, si, ti)["loss"]))


def test_config_cli_and_what_is_not_ported(tmp_path):
    cfg = TrainConfig.from_json(os.path.join(os.path.dirname(__file__), "..", "config",
                                             "config.json"))
    assert cfg.to_dict() == JTrainConfig.from_json(
        os.path.join(os.path.dirname(__file__), "..", "config", "config.json")).to_dict()
    assert TrainConfig().to_dict() == JTrainConfig().to_dict()
    with pytest.raises(ValueError, match="unknown config keys"):
        TrainConfig.from_dict({"nope": 1})
    # item 15's data-parallel training is ported: two replicas on the CPU, and
    # an explicit device list must hold num_devices devices
    dp_cfg = TrainConfig.from_dict(tiny(tmp_path, num_devices=2))
    assert ttr.Trainer(dp_cfg, device="cpu").mesh.shape == {"data": 2, "space": 1}
    with pytest.raises(ValueError, match="needs 2 devices"):
        ttr.Trainer(dp_cfg, device=["cpu"])
    with pytest.raises(ValueError, match="pool_tie"):
        ttr.Trainer(TrainConfig.from_dict(tiny(tmp_path)), device="cpu", pool_tie="last")
    # the CLI: label maps only, 2-D, through main(); and two steps with tie "first"
    import json

    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(tiny(tmp_path, gen_label_only=True, in_shape=[16, 16], num_maps=2,
                                 save_label=False)))
    assert train_main(["--config-path", str(p), "--device", "cpu"]) == {"label_maps": 2}
    p.write_text(json.dumps(tiny(tmp_path, save_label=True, num_maps=3)))
    out = train_main(["--config-path", str(p), "--device", "cpu", "--max-steps", "2",
                      "--pool-tie", "first"])
    assert out["steps"] == 2 and out["trainer"].pool_tie == "first"
    assert len(os.listdir(tmp_path / "labels")) == 3


# ---- checkpoints cross between the packages ---------------------------------

def test_checkpoints_cross_between_the_packages(tmp_path):
    kw = tiny(tmp_path, epochs=1)
    tcfg, jcfg = TrainConfig.from_dict(dict(kw)), JTrainConfig.from_dict(dict(kw))
    out = run_training(tcfg, device="cpu", max_steps=1)
    jtrainer = jtr.Trainer(jcfg)
    mov = np.random.default_rng(5).random((1, 16, 16, 16, 1)).astype(np.float32)
    fx = np.random.default_rng(6).random((1, 16, 16, 16, 1)).astype(np.float32)

    # port -> JAX
    params, _, _ = jtr.load_checkpoint_any(os.path.join(tcfg.model_dir, "final.npz"), jtrainer)
    apply = jax.jit(jtrainer.model.apply)
    want = apply(params, jnp.asarray(mov), jnp.asarray(fx))
    model = out["trainer"].model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(mov), torch.from_numpy(fx))
    # bf16 integration payload on both sides: one bf16 ulp of a ~1e-4 field
    np.testing.assert_allclose(got["warp"].numpy(), np.asarray(want["warp"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["moved"].numpy(), np.asarray(want["moved"]), atol=1e-5, rtol=0)

    # JAX -> port: the flat archive the JAX trainer writes
    jparams, _ = jtrainer.init_state(seed=3)
    np.savez(tmp_path / "from_jax.npz", **jtr._flatten_params(jparams))
    trainer = ttr.Trainer(tcfg, device="cpu")
    assert trainer.load_checkpoint(str(tmp_path / "from_jax.npz")) == 0
    want = apply(jparams, jnp.asarray(mov), jnp.asarray(fx))
    with torch.inference_mode():
        got = trainer.model.eval()(torch.from_numpy(mov), torch.from_numpy(fx))
    np.testing.assert_allclose(got["warp"].numpy(), np.asarray(want["warp"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["moved"].numpy(), np.asarray(want["moved"]), atol=1e-5, rtol=0)


def test_init_like_flax_statistics():
    trainer = ttr.Trainer(TrainConfig(enc=[16] * 4, dec=[16] * 6, in_shape=[16, 16, 16]),
                          device="cpu")
    w = trainer.model.unet.dec_1.conv.weight
    fan_in = w.shape[1] * 27
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05   # LeCun normal
    assert float(w.abs().max()) <= 2.0 / 0.87962566 / np.sqrt(fan_in) + 1e-6
    assert float(trainer.model.unet.dec_1.conv.bias.abs().max()) == 0.0
    assert 5e-6 < float(trainer.model.flow.weight.std()) < 2e-5
    a = trainer.init_state(seed=1)["flow.weight"].clone()
    assert torch.equal(trainer.init_state(seed=1)["flow.weight"], a)
    assert not torch.equal(trainer.init_state(seed=2)["flow.weight"], a)
