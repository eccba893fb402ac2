"""The port's closed-loop learning check (``tools/learn_check.py``) on the CPU
at a tiny size: 16³, 4 labels, a few steps of the flagship model. What it
prints, its keys and finite values, the warm start's step-0 evaluation, and
its Dice helper against the JAX probes' formula
(``benchmarks/svf4_learn_probe.py::_mean_label_dice``, read from that file and
run as it stands), equal on the same label arrays, and its held-out evaluation
(``evaluate``/``identity``) against the probe's chain on the same weights and
pairs: the JAX model's ``apply``, a nearest ``warp`` of the moving labels by
``flow_fullres``, ``_mean_label_dice`` and the JAX NMI. Dice must be equal;
NMI within 1e-4 (the moved images differ in the last bits of float32, and a
value that crosses one of the 100 histogram bin edges moves the NMI by about
1e-5). Whether training learns at full width is shown on the card
(``chip_smoke.py`` phase 9)."""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

from multimodal_registration_torch.tools import learn_check as lc

from _torch_port import label_maps, random_flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = os.path.join(ROOT, "benchmarks", "learned_ref_160x160x192_26lab.npz")
KEYS = {"device", "shape", "num_labels", "steps", "warm", "identity", "trajectory",
        "loss_window", "loss_first_mean", "loss_last_mean", "step_seconds", "nmi_identity",
        "nmi_after", "dice_identity", "dice_after", "learned"}
POINT_KEYS = {"step", "loss", "dice", "nmi", "mean_abs_flow_vox", "sec_per_step"}


def _jax_probe_dice():
    """``_mean_label_dice`` of the JAX probe, compiled from its source alone
    (importing the probe would start JAX's persistent cache)."""
    path = os.path.join(ROOT, "benchmarks", "svf4_learn_probe.py")
    tree = ast.parse(open(path).read(), path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_mean_label_dice")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["_mean_label_dice"]


@pytest.mark.parametrize("num_labels", [2, 4, 16])
@pytest.mark.parametrize("case", ["random", "missing labels", "one map empty", "both empty"])
def test_dice_helper_equals_the_jax_probes_formula(num_labels, case):
    rng = np.random.default_rng(num_labels)
    a = rng.integers(0, num_labels, (12, 10, 8))
    b = np.where(rng.random(a.shape) < 0.3, rng.integers(0, num_labels, a.shape), a)
    if case == "missing labels":
        a, b = np.minimum(a, num_labels // 2), np.minimum(b, max(num_labels // 2 - 1, 0))
    elif case == "one map empty":
        a = np.zeros_like(a)
    elif case == "both empty":
        a, b = np.zeros_like(a), np.zeros_like(b)
    want = _jax_probe_dice()(a, b, num_labels)
    got = lc.mean_label_dice(torch.from_numpy(a), torch.from_numpy(b.astype(np.float32)),
                             num_labels)
    assert got == want
    if case == "both empty":
        assert got == 1.0
    with pytest.raises(ValueError, match="labels outside"):
        lc.mean_label_dice(torch.from_numpy(a), torch.full(a.shape, num_labels), num_labels)


def _eval_pairs(num_labels):
    """Three fixed pairs ``(moving image, moving labels, fixed image, fixed
    labels)`` as numpy arrays: a map and the same map shifted by 1-3 voxels,
    each label drawn at its own random intensity plus noise."""
    maps = label_maps(3, seed=11)
    rng = np.random.default_rng(12)
    pairs = []
    for s in range(3):
        mov_lab = maps[s].astype(np.int64)
        fx_lab = np.roll(maps[s], s + 1, 0).astype(np.int64)
        images = [np.clip(rng.random(num_labels).astype(np.float32)[lab]
                          + 0.05 * rng.standard_normal(lab.shape), 0, 1).astype(np.float32)
                  for lab in (mov_lab, fx_lab)]
        pairs.append((images[0], mov_lab, images[1], fx_lab))
    return pairs


@pytest.mark.parametrize("flow_scale", [5e-3, 5e-2])
def test_evaluation_equals_the_jax_probes_chain(flow_scale):
    import jax.numpy as jnp

    from multimodal_registration_tpu.evalx.nmi import normalized_mutual_information as jax_nmi
    from multimodal_registration_tpu.models import vxm_dense as jvd
    from multimodal_registration_tpu.ops.warp import warp as jax_warp
    from multimodal_registration_tpu.train.trainer import _unflatten_params
    from multimodal_registration_torch.models import vxm_dense as tvd
    from multimodal_registration_torch.models.weights import params_from_jax

    num_labels = 4
    common = dict(enc=(4,) * 4, dec=(4,) * 6, compute_dtype="float32",
                  integrate_payload_dtype="")
    flat = random_flat_params(jvd.VxmConfig(**common), seed=5, flow_scale=flow_scale)
    pairs = _eval_pairs(num_labels)

    tcfg = tvd.VxmConfig(**common)
    model = tvd.VxmDense(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(flat, tcfg))
    pairs_t = [tuple(torch.from_numpy(a) for a in p) for p in pairs]
    got, got_id = lc.evaluate(model, pairs_t, num_labels), lc.identity(pairs_t, num_labels)

    jcfg = jvd.VxmConfig(**common)
    params = _unflatten_params(jvd.params_template(jcfg), flat)
    dice = _jax_probe_dice()
    dices, nmis, flows = [], [], []
    for mov, mov_lab, fx, fx_lab in pairs:
        o = jvd.VxmDense(cfg=jcfg).apply(params, jnp.asarray(mov)[None, ..., None],
                                         jnp.asarray(fx)[None, ..., None])
        flow = o["flow_fullres"][0]
        moved_lab = jax_warp(jnp.asarray(mov_lab, jnp.float32), flow, interp="nearest")
        dices.append(dice(fx_lab, np.asarray(moved_lab), num_labels))
        nmis.append(jax_nmi(fx, np.asarray(o["moved"][0, ..., 0])))
        flows.append(float(jnp.abs(flow).mean()))
    want = {"dice": float(np.mean(dices)), "nmi": float(np.mean(nmis))}
    want_id = {"dice": float(np.mean([dice(fx_lab, mov_lab, num_labels)
                                      for _, mov_lab, _, fx_lab in pairs])),
               "nmi": float(np.mean([jax_nmi(fx, mov) for mov, _, fx, _ in pairs]))}

    assert np.mean(flows) > 0.5  # the labels move: the warp's rounding is exercised
    assert got["dice"] != got_id["dice"]
    assert got["dice"] == want["dice"] and got_id["dice"] == want_id["dice"]
    assert abs(got["nmi"] - want["nmi"]) <= 1e-4, (got, want)
    assert abs(got_id["nmi"] - want_id["nmi"]) <= 1e-4, (got_id, want_id)
    assert got["mean_abs_flow_vox"] == pytest.approx(np.mean(flows), rel=1e-4)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """Leave the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def test_learn_check_from_scratch_prints_its_result(capsys):
    out = lc.main(["6", "--shape", "16", "16", "16", "--labels", "4", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert set(out) == KEYS
    assert out["device"] == "cpu" and out["shape"] == [16, 16, 16] and out["steps"] == 6
    assert out["warm"] is None and isinstance(out["learned"], bool)
    assert [p["step"] for p in out["trajectory"]] == [6]  # evaluated after the last step
    for p in out["trajectory"]:
        assert set(p) == POINT_KEYS and all(_finite(p[k]) for k in POINT_KEYS - {"step"})
        assert 0.0 <= p["dice"] <= 1.0 and p["mean_abs_flow_vox"] > 0
    assert out["loss_window"] == 3
    for k in ("loss_first_mean", "loss_last_mean", "nmi_identity", "nmi_after",
              "dice_identity", "dice_after"):
        assert _finite(out[k]), k
    assert out["identity"] == {"dice": out["dice_identity"], "nmi": out["nmi_identity"]}
    assert out["dice_after"] == out["trajectory"][-1]["dice"]
    assert out["learned"] == (out["nmi_after"] > out["nmi_identity"]
                              and out["dice_after"] > out["dice_identity"])
    s = out["step_seconds"]
    assert s["n"] == 6 and 0 < s["min"] <= s["p50"] <= s["p90"] <= s["max"]


def test_learn_check_warm_start_evaluates_step_zero():
    out, trainer, bank = lc.learn_check(2, (16, 16, 16), 4, warm=WARM, device="cpu")
    assert [p["step"] for p in out["trajectory"]] == [0, 2]
    first = out["trajectory"][0]
    assert first["loss"] is None and first["sec_per_step"] == 0.0
    assert _finite(out["trajectory"][1]["loss"]) and out["warm"] == WARM
    assert bank.shape == (lc.NUM_MAPS, 16, 16, 16) and bank.dtype == torch.uint8
    # the warm weights are the checkpoint's before training: step 0 registers
    # with the learned model, whose flow is far from the fresh head's 1e-5
    assert first["mean_abs_flow_vox"] > 1e-2
    assert trainer.model.unet.enc_0.conv.weight.shape == (64, 2, 3, 3, 3)
    with pytest.raises(ValueError, match="steps"):
        lc.learn_check(0, (16, 16, 16), 4, device="cpu")
