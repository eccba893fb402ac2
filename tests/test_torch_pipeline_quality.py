"""The port's pipeline-quality tool (``tools/pipeline_quality.py``) on the CPU.

  * ``--quick`` of both parts (48^3, 8 labels, 2 subjects, tiny models): the
    artifact's ``summary`` keys and arm names are those of the JAX package's
    in-repo artifacts (``benchmarks/pipeline_parity_artifact*.json``, one
    file a pipeline arm, and ``benchmarks/twostep_parity_artifact.json``),
    read and left untouched; the gates are recorded, not held;
  * one tree of the port's ``build_dataset`` and ``displace_moving`` through
    the JAX package's ``run_batch`` and the tool's arm runner, with the same
    tiny random weights, in the arms ``single``, ``opt_affine_rigid`` and
    ``two_step_smooth``: :func:`collect`'s lists within 1e-3 absolute + 1e-3
    relative (the tolerance of ``test_run_batch_matches_the_jax_package``)
    and the same fallback subjects;
  * ``rigid_displace`` equal to ``benchmarks/learn_model1_workload.py``'s
    (read from its syntax tree) within 1e-6;
  * the cord label's rule, the gates on made-up results, ``main`` raising on
    a failed gate and refusing to write under ``benchmarks/``.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from multimodal_registration_tpu.models.vxm_dense import VxmConfig as JaxVxmConfig
from multimodal_registration_tpu.pipeline import batch as jbatch
from multimodal_registration_tpu.pipeline import segment as jseg
from multimodal_registration_torch.tools import pipeline_quality as pq

from _torch_port import random_flat_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
TINY = dict(enc=[4] * 4, dec=[4] * 6, compute_dtype="float32")


def _jax_artifact(name):
    with open(os.path.join(BENCH, name)) as f:
        return json.load(f)


def _pipeline_artifact_name(arm):
    return "pipeline_parity_artifact.json" if arm == "learned_ref" else \
        f"pipeline_parity_artifact_{arm}.json"


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("quick") / "quality.json")
    art = pq.main(["--quick", "--subjects", "2", "--device", "cpu", "--out", out])
    with open(out) as f:
        assert json.load(f)["gates"] == art["gates"]
    return art


def test_quick_pipeline_matches_the_jax_artifacts_keys(quick):
    part = quick["pipeline"]
    assert tuple(part["arms"]) == pq.PIPELINE_ARMS
    assert part["subjects"] == ["sub-01", "sub-02"]
    for arm, got in part["arms"].items():
        ref = _jax_artifact(_pipeline_artifact_name(arm))
        assert got["summary"].keys() == ref["summary"].keys(), arm
        assert set(ref) <= set(got), (arm, set(ref) - set(got))
        assert len(got["summary"]["dice_before_after"]) == 2
        assert got["batch_ok"]
        assert got["launches"] == dict.fromkeys(got["launches"], 0)  # plain versions on the CPU
    assert part["quick"] and quick["twostep"]["quick"]


def test_quick_twostep_matches_the_jax_artifact_keys(quick):
    part = quick["twostep"]
    ref = _jax_artifact("twostep_parity_artifact.json")
    assert part["summary"].keys() == ref["summary"].keys()
    assert part["arms"].keys() == ref["arms"].keys()
    assert set(ref) <= set(part)
    for arm, got in part["arms"].items():
        assert set(ref["arms"][arm]) <= set(got), arm
        assert got["batch_ok"] and len(got["dice_before_after"]) == 2, arm
    assert set(quick["gates"]) == set(pq.gates(quick["pipeline"], quick["twostep"]))


def _tree(root):
    shape, labels = pq.QUICK_SHAPE, pq.QUICK_LABELS
    engine, scales, _ = pq._engine(True, "cpu")
    data = os.path.join(root, "data")
    subjects = pq.build_dataset(data, shape, labels, 2, engine, scales, pq.TWOSTEP_MAPS_SEED,
                                torch.Generator().manual_seed(0), "cpu")
    pq.displace_moving(data, subjects)
    return data, subjects


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    data, subjects = _tree(root)
    paths = {}
    for name, seed in (("fine", 1), ("smooth", 2)):
        paths[name] = os.path.join(root, f"w{seed}.npz")
        np.savez(paths[name], **random_flat_params(
            JaxVxmConfig(enc=(4,) * 4, dec=(4,) * 6, compute_dtype="float32"), seed,
            flow_scale=2e-3))
    for name, sigma in (("raw", 0.0), ("smooth_cfg", pq.MODEL1_SIGMA)):
        paths[name] = os.path.join(root, f"cfg_{name}.json")
        with open(paths[name], "w") as f:
            json.dump(dict(TINY, model1_svf_smooth_sigma=sigma), f)
    return {"data": data, "subjects": subjects, **paths}


@pytest.mark.parametrize("arm", ["single", "opt_affine_rigid", "two_step_smooth"])
def test_arms_match_the_jax_pipeline(tree, tmp_path, arm):
    m1, m2, gate, smoothed = pq.TWOSTEP_ARMS[arm]
    model, model2 = tree[m1], tree[m2] if m2 else None
    cfg = tree["smooth_cfg" if smoothed else "raw"]
    kw = dict(opt_affine=bool(gate))
    if gate:
        kw["min_sc_dice"] = pq.MIN_SC_DICE
    if gate == "rigid":
        kw["affine_fallback_mode"] = "rigid"
    jout = str(tmp_path / "jax")
    jres, _ = jbatch.run_batch(
        path_data=tree["data"], path_output=jout, model_path=model, config_path=cfg,
        model2_path=model2, jobs=1,
        segmenter=jseg.ThresholdSegmenter(percentile=pq.SEGMENT_PERCENTILE), **kw)
    want = pq.collect(jout, tree["subjects"])
    got = pq.run_arm(tree["data"], str(tmp_path / "torch"), tree["subjects"], model, cfg,
                     model2_path=model2, gate=gate, device="cpu")
    assert got["batch_ok"] and all(r.ok for r in jres)
    assert got["used_affine_fallback"] == [r.subject for r in jres if r.used_affine_fallback]
    if gate:  # tiny weights do not reach the gate: the rigid fallback runs
        assert got["used_affine_fallback"] == tree["subjects"]
    for key in ("dice_before_after", "nmi_percent_improvement", "folding_percent"):
        assert len(got[key]) == len(want[key]) == 2, key
        np.testing.assert_allclose(np.array(got[key], float), np.array(want[key], float),
                                   rtol=1e-3, atol=1e-3, err_msg=key)


def _reference_rigid_displace():
    path = os.path.join(BENCH, "learn_model1_workload.py")
    tree = ast.parse(open(path).read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "rigid_displace")
    scope = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), scope)
    return scope["rigid_displace"]


@pytest.mark.parametrize("seed", [500, 501, 502])
def test_rigid_displace_equals_the_jax_workloads(seed):
    ref = _reference_rigid_displace()
    rng = np.random.default_rng(seed)
    img = rng.random((24, 20, 16)).astype(np.float32)
    lab = rng.integers(0, 5, size=img.shape).astype(np.float32)
    got_img, got_lab = pq.rigid_displace(img, lab, seed)
    want_img, want_lab = ref(img, lab, seed)
    assert got_img.dtype == want_img.dtype == np.float32
    np.testing.assert_allclose(got_img, want_img, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_lab, want_lab)


def test_cord_label_skips_a_label_of_two_equal_pieces():
    lab = np.zeros((40, 40, 40), np.uint8)
    lab[:20] = 3
    lab[2:7, 2:8, 2:18] = 1     # 480 voxels in one piece, ...
    lab[30:35, 2:8, 2:18] = 1   # ... and 480 in another: 960, 1.5 % of the volume
    lab[30:40, 20:30, 20:27] = 2  # 700 voxels in one piece
    counts = np.bincount(lab.ravel(), minlength=4)
    assert np.argmin(np.abs(counts[1:] - 0.015 * lab.size)) + 1 == 1  # the JAX scripts' rule
    assert pq.cord_label(lab, 4) == 2
    lab[2:7, 2:8, 7:18] = 0     # 150 ...
    lab[25:35, 2:8, 2:18] = 1   # ... against 960: one piece dominates
    assert pq.cord_label(lab, 4) == 1


def _pipeline_part(dice_after, folding=0.0, nmi=1.0, fallback=()):
    subjects = ["sub-01", "sub-02"]
    arm = {"batch_ok": True, "used_affine_fallback": list(fallback),
           "summary": {"dice_before_after": [(0.7, d) for d in dice_after],
                       "folding_percent": [folding] * len(dice_after),
                       "nmi_percent_improvement": [nmi] * len(dice_after)}}
    return {"subjects": subjects, "arms": {a: json.loads(json.dumps(arm))
                                           for a in pq.PIPELINE_ARMS}}


def test_gates_fail_on_one_subject_or_a_missing_row():
    assert all(pq.gates(_pipeline_part([0.9, 0.95])).values())
    cases = {
        "SC-Dice after >= 0.8": _pipeline_part([0.9, 0.79]),
        "NMI gain > 0": _pipeline_part([0.9, 0.95], nmi=0.0),
        "folding <= 0.1 %": _pipeline_part([0.9, 0.95], folding=0.11),
        "no affine fallback": _pipeline_part([0.9, 0.95], fallback=["sub-02"]),
    }
    for what, part in cases.items():
        failed = [k for k, ok in pq.gates(part).items() if not ok]
        assert failed and all(what in k for k in failed), (what, failed)
    short = _pipeline_part([0.9])  # a subject without a CSV row
    assert not all(pq.gates(short).values())
    gap = _pipeline_part([0.9, 0.95])
    gap["arms"]["w256_int8"]["summary"]["dice_before_after"] = [(0.7, 0.88), (0.7, 0.95)]
    assert [k for k, ok in pq.gates(gap).items() if not ok] == [
        "pipeline: int8 mean SC-Dice after within 0.005 of bf16's"]
    two = {"arms": {a: {"batch_ok": True} for a in pq.TWOSTEP_ARMS},
           "summary": {"sc_dice_after_single": 0.7, "sc_dice_after_two_step": 0.9,
                       "worst_folding_two_step": 2.0, "worst_folding_two_step_smooth": 0.2}}
    assert all(pq.gates(twostep=two).values())
    two["summary"]["worst_folding_two_step_smooth"] = 2.5
    assert not all(pq.gates(twostep=two).values())


def test_main_raises_on_a_failed_gate_and_never_writes_under_benchmarks(monkeypatch, tmp_path):
    def fake_run(part, device, quick, *args):
        art = {"pipeline": _pipeline_part([0.9, 0.5])}
        art["gates"] = pq.gates(art["pipeline"])
        return art

    monkeypatch.setattr(pq, "run", fake_run)
    out = tmp_path / "a.json"
    with pytest.raises(pq.GateFailure, match="SC-Dice"):
        pq.main(["pipeline", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["gates"]  # written before raising
    pq.main(["pipeline", "--quick", "--device", "cpu", "--out", str(out)])  # recorded only
    with pytest.raises(ValueError, match="never writes under"):
        pq.main(["--quick", "--device", "cpu", "--out", os.path.join(BENCH, "x.json")])
