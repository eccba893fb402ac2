"""The plain reference against the port's plain path at a small size on the
CPU, in float32: the forward, the synthesis from the same generator, and
training steps. The reference imports nothing of the port."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.drivers import train as train_drv
from perfbench.reference import inputs, ops, synth
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SHAPE = (32, 32, 32)
MODEL = {"enc": [8] * 4, "dec": [8] * 6, "int_steps": 5, "int_res": 2, "svf_res": 2}
SYNTH = {"num_labels": 6, "vel_std": 3.0, "vel_res": 16.0, "bias_std": 0.3, "bias_res": 40.0,
         "blur_std": 1.0, "gamma": 0.25, "svf_int_res": 4, "lr": 1e-4, "reg_param": 1.0}


def bank(seed=3, count=3):
    return inputs.label_bank(seed, count, SHAPE, 6, [4, 8, 16], [4, 8, 16], CPU)


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; import perfbench.reference.model, perfbench.reference.train, "
            "perfbench.reference.inputs; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'multimodal_registration_tpu', "
            "'multimodal_registration_torch'}; print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_label_bank_is_seeded_and_has_many_labels():
    a, b = bank(3), bank(3)
    assert torch.equal(a, b) and a.dtype == torch.uint8
    assert not torch.equal(a, bank(4))
    assert all(len(torch.unique(m)) >= 3 for m in a)


@pytest.mark.parametrize("payload", ["", "bfloat16"])
def test_forward_matches_the_port_in_float32(payload):
    from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense

    w = ref_model.make_weights(11, MODEL, 0.1, CPU)
    mov, fix = inputs.pairs(11, bank(), 2, 6, 2.0, 16, 0.02)
    net = VxmDense(VxmConfig(enc=(8,) * 4, dec=(8,) * 6, compute_dtype="float32",
                             integrate_payload_dtype=payload), device=CPU).eval()
    net.load_state_dict(w)
    ops.no_tf32()
    with torch.no_grad():
        out = net(mov[..., None], fix[..., None])
        moved, warp = ref_model.forward(w, mov, fix, {**MODEL, "payload": payload})
    assert warp.abs().max() > 0.1  # the serving head std gives a field of some voxels' tenths
    torch.testing.assert_close(out["warp"], warp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["moved"][..., 0], moved, rtol=1e-4, atol=1e-5)


def test_synthesis_draws_and_images_match_the_port():
    from multimodal_registration_torch.synth.image_engine import ImageEngineConfig
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import build_batch, draw_batch

    maps = bank()
    ecfg = ImageEngineConfig(num_labels=6, svf_int_res=4)  # the field gathered in bf16
    tcfg = TrainConfig(in_shape=list(SHAPE), num_labels=6)
    draws = draw_batch(torch.Generator().manual_seed(9), maps[0:1], maps[1:2], ecfg, tcfg,
                       False)
    port = build_batch(draws, ecfg)
    ref = ref_train.synthesise(torch.Generator().manual_seed(9), maps, 0, 1, SYNTH)
    torch.testing.assert_close(port["img1"][0], ref["img1"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(port["img2"][0], ref["img2"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(port["map2"][0], ref["map2"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(port["phi1s"][0], ref["phi1s"], rtol=1e-4, atol=1e-5)
    assert torch.equal(port["raw1"][0].long(), ref["raw1"].long())


def test_training_steps_match_the_port_in_float32():
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import Trainer

    maps = bank()
    w = ref_model.make_weights(5, MODEL, 1e-5, CPU)
    src, trg = train_drv.indices(5, 8, 3)
    tr = Trainer(TrainConfig(in_shape=list(SHAPE), num_labels=6, enc=[8] * 4, dec=[8] * 6,
                             compute_dtype="float32", num_devices=1), device="cpu")
    tr.model.load_state_dict(w)
    gen = tr.generator(5)
    names = {p: k for k, p in tr.model.named_parameters()}
    losses = []
    for i in range(3):
        losses.append(float(tr.train_step_banked(gen, maps, torch.as_tensor(src[i: i + 1]),
                                                 torch.as_tensor(trg[i: i + 1]))["loss"]))
        if i == 0:
            grads = {names[p]: s["exp_avg"] / 0.1 for p, s in tr.optimizer.state.items()}
    ref = ref_train.steps(w, maps, src, trg, torch.Generator().manual_seed(5), SYNTH, MODEL, 3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert max(train_drv.leaf_gaps(grads, ref["grads"], list(w))) < 0.005
    after = dict(tr.model.state_dict())
    change_p = {k: after[k] - w[k] for k in w}
    change_r = {k: ref["params"][k] - w[k] for k in w}
    assert max(train_drv.leaf_gaps(change_p, change_r, list(w))) < 0.02


def test_fp8_conv_rounds_forward_and_backward():
    torch.manual_seed(0)
    x = torch.randn(1, 4, 6, 6, 6, requires_grad=True)
    w = torch.randn(5, 4, 3, 3, 3, requires_grad=True)
    b = torch.zeros(5, requires_grad=True)
    y = ref_train.fp8_conv(x, w, b)
    y_ref = ref_model.conv3d(x, w, b)
    rel = float((y - y_ref).norm() / y_ref.norm())
    assert 1e-3 < rel < 0.1
    g = torch.randn_like(y)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), g)
    rx, rw, rb = torch.autograd.grad(y_ref, (x, w, b), g)
    assert 1e-3 < float((gw - rw).norm() / rw.norm()) < 0.2
    assert 1e-3 < float((gx - rx).norm() / rx.norm()) < 0.2
    torch.testing.assert_close(gb, rb)


def test_gaussian_blur_keeps_the_mass_inside():
    img = torch.zeros(9, 9, 9)
    img[4, 4, 4] = 1.0
    out = ops.gaussian_blur(img, torch.tensor(1.0), 3)
    assert float(out.sum()) == pytest.approx(1.0, rel=1e-5)
    assert float(out[4, 4, 4]) == float(out.max())


def test_flip_mask_draws_like_the_port():
    from multimodal_registration_torch.synth.augment import draw_flip_mask

    for seed in range(5):
        a = draw_flip_mask(torch.Generator().manual_seed(seed))
        b = synth.draw_pair(torch.Generator().manual_seed(seed), CPU)
        assert torch.equal(a, b)
