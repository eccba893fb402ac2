"""The rest of the single-device surface of the port against the JAX package:
``utils/profiling.py`` (``StepTimer``, ``device_trace``), the Keras ``.h5``
export, the ``MMREG_F64_OUTPUTS`` switch of ``register()`` and of the
Jacobian evaluator, TensorBoard scalars under ``MMREG_TENSORBOARD=1``, the
validation losses of ``metrics.csv`` (fault F10), and the port's checkpoints
read by the JAX package after a few CPU steps.

Tolerances: the timer's records, file lines and summary, the ``.h5`` files'
names, attributes and arrays, and weights crossing between the packages are
equal (0); output files go through ``_torch_port.assert_same_outputs``
(fields within 1 bf16 ulp of their magnitude, moved intensities within that
or 1e-3, the Jacobian determinant of one field within 1e-5) with equal
dtypes; TensorBoard scalars equal the ``metrics.csv`` values rounded to
float32, the event file's type; forwards of the same weights within 1e-5
(as ``test_torch_train_cli.py``)."""

import csv
import importlib
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_registration_tpu.infer import config as jconf
from multimodal_registration_tpu.models import h5_export as jh5x
from multimodal_registration_tpu.models.h5_import import import_keras_vxm_h5 as jax_h5_import
from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.models.vxm_dense import params_template
from multimodal_registration_tpu.train import trainer as jtr
from multimodal_registration_tpu.train.config import TrainConfig as JTrainConfig
from multimodal_registration_tpu.utils import nifti as jnifti
from multimodal_registration_tpu.utils import profiling as jprof
from multimodal_registration_torch.infer import config as tconf
from multimodal_registration_torch.infer import register as treg
from multimodal_registration_torch.models import h5_export as th5x
from multimodal_registration_torch.models import h5_import as th5
from multimodal_registration_torch.models.vxm_dense import VxmConfig
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.train import cli as tcli
from multimodal_registration_torch.train import trainer as ttr
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.utils import nifti as tnifti
from multimodal_registration_torch.utils import profiling as tprof

from _torch_port import (assert_same_outputs, label_maps, random_flat_params, scan_affine,
                         write_scan_pair)
from _torch_port import tiny_train_cfg as tiny
from test_torch_isolation import FORBIDDEN, PKG, _imported_modules, _port_sources

jreg = importlib.import_module("multimodal_registration_tpu.infer.register")
jev = importlib.import_module("multimodal_registration_tpu.evalx.cli")
tev = importlib.import_module("multimodal_registration_torch.evalx.cli")

NEW_MODULES = ("utils/profiling.py", "models/h5_export.py", "tools/learn_check.py")


def test_new_modules_are_scanned_and_import_nothing_of_jax():
    files = _port_sources()
    for rel in NEW_MODULES:
        path = os.path.join(PKG, rel)
        assert path in files, rel
        assert not [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN], rel


# ---- utils/profiling.py ------------------------------------------------------

def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


DURATIONS = [0.25, 0.125, 1.5, 0.0625, 0.75, 0.5, 0.375, 2.0, 0.03125, 1.0, 0.875]


def _run_timer(timer_cls, monkeypatch, path, durations):
    ticks, t = [], 10.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 1.0
    _fake_clock(monkeypatch, ticks)
    timer = timer_cls(path=path)
    for i in range(len(durations)):
        timer.start()
        timer.stop(step=i, phase="train" if i % 2 else "val")
    return timer


@pytest.mark.parametrize("n", [1, 2, 10, len(DURATIONS)])
def test_step_timer_matches_jax(tmp_path, monkeypatch, n):
    want = _run_timer(jprof.StepTimer, monkeypatch, str(tmp_path / "jax.jsonl"), DURATIONS[:n])
    got = _run_timer(tprof.StepTimer, monkeypatch, str(tmp_path / "port.jsonl"), DURATIONS[:n])
    assert got.records == want.records and len(got.records) == n
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    assert got.summary() == want.summary()
    assert set(got.summary()) == {"n", "mean", "p50", "p90", "min", "max"}
    assert tprof.StepTimer().summary() == jprof.StepTimer().summary() == {}


def test_step_timer_waits_for_the_card_before_reading_the_clock(monkeypatch):
    events = []
    clock = iter([1.0, 3.5])

    def perf_counter():
        events.append("clock")
        return next(clock)

    monkeypatch.setattr(time, "perf_counter", perf_counter)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: events.append(("sync", d)))
    timer = tprof.StepTimer(sync="cuda:0")
    timer.start()
    assert timer.stop(step=0) == 2.5
    assert events == ["clock", ("sync", "cuda:0"), "clock"]
    # without a device to wait for, nothing synchronises
    events.clear()
    clock = iter([1.0, 2.0])
    timer = tprof.StepTimer()
    timer.start()
    assert timer.stop() == 1.0 and events == ["clock", "clock"]


def test_device_trace_writes_a_readable_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.device_trace(log_dir) as path:
        x = torch.randn(64, 64)
        (x @ x).relu_().sum()
    assert os.path.dirname(path) == log_dir and os.path.exists(path)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"aten::mm", "aten::relu_", "aten::sum"} <= names, sorted(names)[:40]


# ---- models/h5_export.py -----------------------------------------------------

def _h5_contents(path):
    import h5py

    def attr(a):  # the stored type and the names
        a = np.asarray(a)
        return a.dtype.str, [n.decode() if isinstance(n, bytes) else str(n) for n in a]

    out = {}
    with h5py.File(path, "r") as f:
        mw = f["model_weights"]
        out["layer_names"] = attr(mw.attrs["layer_names"])
        for lname in mw:
            out[f"{lname}/weight_names"] = attr(mw[lname].attrs["weight_names"])

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj)

        f.visititems(visit)
    return out


@pytest.mark.parametrize("arch", [((4,) * 4, (4,) * 6), ((4, 6, 6, 8), (8, 6, 6, 4, 5))])
def test_h5_export_matches_jax(tmp_path, arch):
    pytest.importorskip("h5py")
    enc, dec = arch
    jcfg, tcfg = JaxVxmConfig(enc=enc, dec=dec), VxmConfig(enc=enc, dec=dec)
    flat = random_flat_params(jcfg, seed=11)
    jparams = jtr._unflatten_params(params_template(jcfg), flat)
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jh5x.export_keras_vxm_h5(jparams, jcfg, jpath)
    th5x.export_keras_vxm_h5(params_from_jax(flat, tcfg), tcfg, tpath)

    want, got = _h5_contents(jpath), _h5_contents(tpath)
    assert sorted(got) == sorted(want)
    assert len(got["layer_names"][1]) == len(th5.conv_module_order(tcfg)) + 1
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype == np.float32, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k

    # each package's importer reads the other's file into its own params, exactly
    jback = jtr._flatten_params(jax_h5_import(tpath, params_template(jcfg), jcfg))
    assert sorted(jback) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(jback[k], flat[k], err_msg=k)
    tback, twant = th5.import_keras_vxm_h5(jpath, tcfg), params_from_jax(flat, tcfg)
    assert sorted(tback) == sorted(twant)
    for k in twant:
        torch.testing.assert_close(tback[k], twant[k], atol=0, rtol=0, msg=k)


def test_checkpoints_of_a_few_steps_load_in_the_jax_package(tmp_path):
    """Three CPU steps of the port's trainer, saved as its flat ``.npz`` and
    exported to ``.h5``: the JAX package's ``load_checkpoint_any`` reads both,
    and its forward of either equals the port's."""
    pytest.importorskip("h5py")
    kw = tiny(tmp_path, compute_dtype="float32")
    trainer = ttr.Trainer(TrainConfig.from_dict(dict(kw)), device="cpu")
    src, trg = trainer.put_batch(label_maps(2, 3), label_maps(2, 4))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    gen = trainer.generator(7)
    for _ in range(3):
        trainer.train_step(gen, src, trg)
    assert all(not torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    stem = str(tmp_path / "ckpt" / "step3")
    trainer.save_checkpoint(stem, epoch=3)
    th5x.export_keras_vxm_h5(trainer.model.state_dict(), trainer.vxm_cfg, stem + ".h5")

    jtrainer = jtr.Trainer(JTrainConfig.from_dict(dict(kw)))
    rng = np.random.default_rng(8)
    mov, fx = (rng.random((1, 16, 16, 16, 1)).astype(np.float32) for _ in range(2))
    with torch.inference_mode():
        got = trainer.model.eval()(torch.from_numpy(mov), torch.from_numpy(fx))
    apply = jax.jit(jtrainer.model.apply)
    for path in (stem + ".npz", stem + ".h5"):
        params, _, _ = jtr.load_checkpoint_any(path, jtrainer)
        want = apply(params, jnp.asarray(mov), jnp.asarray(fx))
        for k in ("warp", "moved"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                       err_msg=f"{path}: {k}")


# ---- MMREG_F64_OUTPUTS -------------------------------------------------------

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


@pytest.mark.parametrize("f64", [False, True])
def test_f64_outputs_switch_matches_jax(tmp_path, monkeypatch, registrars, f64):
    if f64:
        monkeypatch.setenv("MMREG_F64_OUTPUTS", "1")
    else:
        monkeypatch.delenv("MMREG_F64_OUTPUTS", raising=False)
    fixed = (FIXED[0], scan_affine(*FIXED))
    moving = (MOVING[0], scan_affine(*MOVING))
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for (side, d), nifti_mod, conf, reg, r in zip(
            dirs.items(), (jnifti, tnifti), (jconf, tconf), (jreg, treg), registrars):
        write_scan_pair(str(d), nifti_mod, fixed, moving)
        cfg = conf.InferenceConfig.from_dict(dict(ARCH))
        reg.register(cfg, r, str(d / "fx.nii.gz"), str(d / "mov.nii.gz"), fx_contrast="T2w",
                     naming="standalone", res_dir=str(d / "res"))
    # the Jacobian evaluator of each package on the same field (the JAX one's)
    field = jnifti.load(str(dirs["jax"] / "res" / "deform_field.nii.gz"))
    for (side, d), ev in zip(dirs.items(), (jev, tev)):
        kw = {} if side == "jax" else {"device": "cpu"}
        ev.eval_with_jacobian_arrays(field.get_fdata(), field.affine, "sub-01",
                                     str(tmp_path / f"jac_{side}.csv"),
                                     str(d / "res" / "detJa.nii.gz"), **kw)
    names = assert_same_outputs(str(dirs["jax"]), str(dirs["port"]))
    want = np.float64 if f64 else np.float32
    for name in ("res/warped_im.nii.gz", "res/detJa.nii.gz"):
        assert name in names
        for d in dirs.values():
            assert tnifti.load(str(d / name)).dataobj.dtype == want, (d, name)
    # the other outputs keep their types whatever the switch says
    assert tnifti.load(str(dirs["port"] / "res/deform_field.nii.gz")).dataobj.dtype == np.float32


# ---- train/cli.py: F10 and TensorBoard ---------------------------------------

def _metrics_rows(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return rows


SENTINEL = {"loss": 5.0, "dice_loss": 7.0, "grad_loss": 9.0}


def test_metrics_row_takes_the_last_validation_steps_losses(tmp_path, monkeypatch):
    """Fault F10: the JAX package's ``run_training`` reassigns ``aux`` in its
    validation loop, so a row's ``dice_loss`` and ``grad_loss`` are the last
    validation step's whenever validation runs. A validation step patched to
    return sentinels shows where the port takes them from."""
    calls = []

    def val_step_banked(self, gen, bank, si, ti):
        calls.append(len(calls))
        return {k: torch.tensor(v + len(calls)) for k, v in SENTINEL.items()}

    monkeypatch.setattr(ttr.Trainer, "val_step_banked", val_step_banked)
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=2, num_maps=8, train_frac=0.75))
    out = tcli.run_training(cfg, device="cpu")
    assert len(calls) == 4  # two validation maps, two epochs
    for epoch, row in enumerate(out["history"]):
        last = 2 * (epoch + 1)  # the sentinels of the epoch's last validation step
        assert row["dice_loss"] == SENTINEL["dice_loss"] + last
        assert row["grad_loss"] == SENTINEL["grad_loss"] + last
        assert row["val_loss"] == np.mean([SENTINEL["loss"] + last - 1, SENTINEL["loss"] + last])
        assert row["loss"] != row["val_loss"]  # the training loss stays the training steps'
    rows = _metrics_rows(cfg.log_dir)
    assert [float(r["dice_loss"]) for r in rows] == [h["dice_loss"] for h in out["history"]]

    # without validation maps the row keeps the last training step's losses
    monkeypatch.undo()
    cfg = TrainConfig.from_dict(tiny(tmp_path / "noval", epochs=1, train_frac=1.0))
    row = tcli.run_training(cfg, device="cpu")["history"][0]
    assert np.isnan(row["val_loss"]) and np.isfinite(row["dice_loss"])


def _scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_equal_the_metrics_rows(tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    monkeypatch.setenv("MMREG_TENSORBOARD", "1")
    cfg = TrainConfig.from_dict(tiny(tmp_path, epochs=3))
    out = tcli.run_training(cfg, device="cpu")
    rows = _metrics_rows(cfg.log_dir)
    scalars = _scalars(cfg.log_dir)
    tags = ("loss", "dice_loss", "grad_loss", "val_loss")
    assert sorted(scalars) == sorted(tags)
    for tag in tags:
        want = [(int(r["epoch"]), float(np.float32(float(r[tag])))) for r in rows]
        assert scalars[tag] == want, tag
    assert [s for s, _ in scalars["loss"]] == [1, 2, 3] == [h["epoch"] for h in out["history"]]


def test_tensorboard_off_or_missing_leaves_the_run_alone(tmp_path, monkeypatch, capsys):
    # switched off: no event file
    monkeypatch.delenv("MMREG_TENSORBOARD", raising=False)
    cfg = TrainConfig.from_dict(tiny(tmp_path / "off", epochs=1))
    tcli.run_training(cfg, device="cpu")
    assert not [n for n in os.listdir(cfg.log_dir) if "tfevents" in n]
    # switched on without the package: one warning line, the run goes on
    monkeypatch.setenv("MMREG_TENSORBOARD", "1")
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = TrainConfig.from_dict(tiny(tmp_path / "missing", epochs=1))
    out = tcli.run_training(cfg, device="cpu")
    assert out["steps"] == 2 and len(_metrics_rows(cfg.log_dir)) == 1
    warnings = [l for l in capsys.readouterr().out.splitlines() if l.startswith("warning:")]
    assert len(warnings) == 1 and "MMREG_TENSORBOARD" in warnings[0], warnings
    assert not [n for n in os.listdir(cfg.log_dir) if "tfevents" in n]
