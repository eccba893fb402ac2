"""The port's study tools on the CPU against the JAX scripts and the JAX package.

``multimodal_registration_torch/tools/``: ``ablate``, ``unet_bwd_probe``,
``cascade_folding_probe``, ``cascade_smoothing_sweep`` and
``opt_affine_rotation_study``, the counterparts of the ``benchmarks/``
scripts of the same names.

  * flags, defaults, row names and record keys equal the JAX scripts', read
    from their syntax trees (importing them would import JAX and start its
    cache); the port adds ``--device`` and ``--out`` (the rotation study,
    which does no device work, only ``--out``);
  * ``ablate`` at 16^3 and ``unet_bwd_probe --small``: every row positive;
    ``ConvLeaky``'s forward with the pools ``none``, ``xla`` and ``reshape``
    against the JAX script's module (its class, compiled from its source) on
    the same weights at 8^3: within 1 bf16 ulp of max|out| (bf16 convs summed
    in another order, each output rounded once);
  * ``cascade_folding_probe`` at 48^3 with the in-repo ``learned_model1`` and
    ``learned_ref`` weights, float32, on one subject made with numpy: the
    port's ``Registrar``, ``compose_fields``, ``rescale_field`` and folding
    summary against the JAX package's and the JAX script's own
    ``export_fold``: folding within 0.01 percentage points, mean |flow|
    within 1e-3 voxel; the port's ``numpy_compose`` against its
    ``compose_fields`` within 1e-4 voxel;
  * ``cascade_smoothing_sweep``'s rows at 48^3 for sigma 0 and 1.5 against
    the same rows formed from the JAX package's ``smooth_field``,
    ``integrate_svf``, ``warp`` and ``compose_fields`` and the JAX script's
    own ``label_dice`` and ``interior_fold``: the same tolerances, Dice within
    0.002;
  * ``cascade_folding_probe --quick --device cpu`` and the sweep's ``run``
    with ``quick`` (48^3, zero weights, float32: no folding); the sweep's
    ``--tpu`` is accepted and changes nothing; every tool, ``--quick`` and
    ``--tpu`` included, raises without a card unless ``--device cpu``;
  * ``opt_affine_rotation_study`` at its full 96x96x128 tube against the
    committed ``benchmarks/opt_affine_rotation_results.json`` (Dice within
    0.002, angles within 0.05 degree, the summary's booleans equal), and the
    port's ``centermass_affine_field`` / ``rigid_affine_field`` against the
    JAX package's on a 48x48x64 tube (float32 fields, 1e-5 voxel).
"""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from multimodal_registration_torch.tools import ablate, unet_bwd_probe
from multimodal_registration_torch.tools import cascade_folding_probe as cfp
from multimodal_registration_torch.tools import cascade_smoothing_sweep as css
from multimodal_registration_torch.tools import opt_affine_rotation_study as oars
from multimodal_registration_torch.tools.pipeline_quality import rigid_displace

from _torch_port import bf16_ulp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
SUB_SHAPE, SUB_LABELS = (48, 48, 48), 6


def _source(name):
    path = os.path.join(BENCH, name)
    return path, open(path).read()


def _tree(name):
    path, src = _source(name)
    return ast.parse(src, path)


def _compiled(name, defs, ns):
    """The script's top-level or nested definitions ``defs``, compiled from its
    source into ``ns``."""
    path, src = _source(name)
    nodes = [n for n in ast.walk(ast.parse(src, path))
             if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name in defs]
    assert {n.name for n in nodes} == set(defs)
    exec(compile(ast.Module(nodes, []), path, "exec"), ns)
    return ns


def _argparse_flags(tree):
    out = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in n.keywords
                  if k.arg in ("default", "action")}
            out[n.args[0].value] = kw.get(
                "default", False if kw.get("action") == "store_true" else None)
    return out


def _port_flags(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: a.default
            for a in parser._actions if a.dest != "help"}


def _dict_key_sets(tree):
    return {frozenset(k.value for k in n.keys) for n in ast.walk(tree)
            if isinstance(n, ast.Dict) and n.keys
            and all(isinstance(k, ast.Constant) for k in n.keys)}


def _quiet(*_):
    pass


# ---- flags, defaults and keys ------------------------------------------------------

def test_ablate_flags_and_rows_equal_the_jax_scripts():
    tree = _tree("ablate.py")
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert ast.literal_eval(main.args.defaults[0]) == ablate.SHAPE == (192, 192, 192)
    rows = [n.slice.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
            and getattr(n.value, "id", None) == "results" and isinstance(n.slice, ast.Constant)]
    assert tuple(rows) == ablate.ROWS
    timed = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "timed_chain")
    assert ast.literal_eval(timed.args.defaults[0]) == ablate.ITERS
    assert _port_flags(ablate.build_parser()) == {"--device": None, "--out": None}


def test_unet_bwd_probe_flags_and_sections_equal_the_jax_scripts():
    tree = _tree("unet_bwd_probe.py")
    sections = [n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "fwd_vs_bwd"]
    assert tuple(sections) == unet_bwd_probe.SECTIONS
    suffixes = {v.value for n in ast.walk(tree) if isinstance(n, ast.JoinedStr)
                for v in n.values if isinstance(v, ast.Constant)}
    assert {"_fwd_ms", "_fwd_bwd_ms", "_bwd_ms"} <= suffixes
    default = next(n.orelse.value for n in ast.walk(tree) if isinstance(n, ast.IfExp)
                   and isinstance(n.orelse, ast.Constant))
    pools = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef))
    assert default == 6 and "--small" in {n.value for n in ast.walk(tree)
                                          if isinstance(n, ast.Constant)}
    assert {n.value for n in ast.walk(pools) if isinstance(n, ast.Constant)
            and n.value in unet_bwd_probe.POOLS} == set(unet_bwd_probe.POOLS)
    assert _port_flags(unet_bwd_probe.build_parser()) == {
        "iters": 6, "--small": False, "--device": None, "--out": None}


def test_cascade_tools_flags_equal_the_jax_scripts():
    assert _port_flags(cfp.build_parser()) == {
        **_argparse_flags(_tree("cascade_folding_probe.py")), "--device": None, "--out": None}
    want = _argparse_flags(_tree("cascade_smoothing_sweep.py"))
    assert _port_flags(css.build_parser()) == {**want, "--device": None, "--out": None}
    assert tuple(want["--sigmas"]) == css.SIGMAS
    assert _port_flags(oars.build_parser()) == {"--out": None}
    jax_cases = next(n for n in ast.walk(_tree("opt_affine_rotation_study.py"))
                     if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "cases")
    assert tuple(ast.literal_eval(jax_cases.value)) == oars.CASES


# ---- ablate and unet_bwd_probe -------------------------------------------------------

def test_ablate_runs_at_16_cubed_with_positive_rows():
    res = ablate.run((16, 16, 16), "cpu", emit=_quiet)
    assert list(res) == ["shape", *ablate.ROWS] and res["shape"] == [16, 16, 16]
    assert all(res[r] > 0 for r in ablate.ROWS)
    assert all(res[r] == round(res[r], 2) for r in ablate.ROWS)


def test_unet_bwd_probe_runs_small_with_positive_rows():
    lines = []
    res = unet_bwd_probe.run(1, True, "cpu", emit=lines.append)
    want = [f"{s}_{k}_ms" for s in unet_bwd_probe.SECTIONS for k in ("fwd", "fwd_bwd", "bwd")]
    assert list(res) == ["shape", *want] and res["shape"] == [32, 32, 48]
    assert all(res[k] > 0 for k in want)
    assert [list(json.loads(ln)) for ln in lines[:-1]] == [
        [f"{s}_{k}_ms" for k in ("fwd", "fwd_bwd", "bwd")] for s in unet_bwd_probe.SECTIONS]
    assert json.loads(lines[-1]) == res


@pytest.mark.parametrize("pool", ["none", "xla", "reshape"])
def test_conv_leaky_equals_the_jax_scripts_module(pool):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    JaxConvLeaky = _compiled("unet_bwd_probe.py", {"ConvLeaky"},
                             {"nn": nn, "jnp": jnp})["ConvLeaky"]
    rng = np.random.default_rng(1)
    for cin, feats in ((2, (64,)), (64, (64, 64, 64))):
        x = rng.normal(size=(1, 8, 8, 8, cin)).astype(np.float32)
        if pool == "none" and len(feats) > 1:
            continue
        jm = JaxConvLeaky(feats, pool)
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
        tm = unet_bwd_probe.ConvLeaky(cin, feats, pool, device="cpu")
        with torch.no_grad():
            for i, conv in enumerate(tm.convs):
                p = params["params"][f"c{i}"]
                conv.weight.copy_(torch.as_tensor(p["kernel"].transpose(4, 3, 0, 1, 2).copy()))
                conv.bias.copy_(torch.as_tensor(np.array(p["bias"])))
            got = tm(torch.as_tensor(x)).float().numpy()
        want = np.asarray(jm.apply(params, x).astype(jnp.float32))
        assert got.shape == want.shape
        tol = bf16_ulp(float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol, (pool, cin, np.abs(got - want).max(), tol)


# ---- the cascade folding probe and the smoothing sweep -------------------------------

def _numpy_subject(seed=0):
    """Labels from smoothed noise, two contrasts of them, the moving one
    rigidly displaced (``rigid_displace`` seed 501), both min-max scaled."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    noise = ndimage.gaussian_filter(rng.normal(size=(SUB_LABELS, *SUB_SHAPE)), (0, 4, 4, 4))
    lab = noise.argmax(0).astype(np.uint8)
    fx = ndimage.gaussian_filter(rng.uniform(0, 1, SUB_LABELS)[lab], 1.0).astype(np.float32)
    mov = ndimage.gaussian_filter(rng.uniform(0, 1, SUB_LABELS)[lab], 1.0).astype(np.float32)
    mov, mov_lab = rigid_displace(mov, lab, 501)
    fx = (fx - fx.min()) / (fx.max() - fx.min())
    mov = (mov - mov.min()) / (mov.max() - mov.min())
    return {"fx": fx.astype(np.float32), "mov": mov.astype(np.float32), "lab": lab,
            "mov_lab": mov_lab}


@pytest.fixture(scope="module")
def cascade():
    """The port's and the JAX package's registrars on the in-repo checkpoints,
    float32, and the numpy subject."""
    import importlib

    from multimodal_registration_tpu.infer import config as jconf

    jreg = importlib.import_module("multimodal_registration_tpu.infer.register")

    d = dict(enc=[64] * 4, dec=[64] * 6, int_steps=5, int_res=2, svf_res=2,
             compute_dtype="float32")
    cfg = cfp.inference_config(cfp.train_config(False), "float32")
    assert {k: getattr(cfg, k) for k in d} == d
    t1, t2, _ = cfp.registrars(False, cfg, "cpu")
    jcfg = jconf.InferenceConfig.from_dict(d)
    j1 = jreg.Registrar(jcfg, jreg.load_params_any(cfp.CKPT1, jcfg))
    j2 = jreg.Registrar(jcfg, jreg.load_params_any(cfp.CKPT2, jcfg))
    return {"port": (t1, t2), "jax": (j1, j2), "sub": _numpy_subject()}


def _jax_scripts_helpers():
    import jax.numpy as jnp

    return _compiled("cascade_folding_probe.py", {"export_fold", "numpy_compose"},
                     {"np": np, "jnp": jnp})


def test_folding_probe_equals_the_jax_package(cascade):
    import jax.numpy as jnp

    from multimodal_registration_tpu.infer.cascade import _compose_full_jit
    from multimodal_registration_tpu.ops.field import compose_fields
    from multimodal_registration_tpu.ops.resize import rescale_field

    sub = cascade["sub"]
    fx, mov = sub["fx"], sub["mov"]
    got = cfp.probe(*cascade["port"], fx, mov, "cpu")
    # the JAX script's main, from the registrars on
    ns = _jax_scripts_helpers()
    j1, j2 = cascade["jax"]
    moved1_b, warp1_b = j1.predict(mov[None], fx[None])
    _, warp2_b = j2.predict(moved1_b[0][None], fx[None])
    warp1, warp2 = warp1_b[0], warp2_b[0]
    scale, full = 2, SUB_SHAPE
    up = lambda w: np.asarray(rescale_field(jnp.asarray(w), scale, out_shape=full))  # noqa: E731
    comp_int = np.asarray(compose_fields(jnp.asarray(warp1), jnp.asarray(warp2)))
    comp_np = ns["numpy_compose"](np.asarray(warp1, np.float64),
                                  np.asarray(warp2, np.float64)).astype(np.float32)
    comp_full = np.asarray(_compose_full_jit(jnp.asarray(warp1), jnp.asarray(warp2), scale,
                                             full))
    want_flow = {"warp1(at int-res grid)": float(np.abs(warp1).mean()),
                 "warp2(at int-res grid)": float(np.abs(warp2).mean())}
    want_fold = {
        "warp1_only": ns["export_fold"](up(warp1)),
        "warp2_only": ns["export_fold"](up(warp2)),
        "int_compose(reference semantics)": ns["export_fold"](up(comp_int)),
        "int_compose_numpy_vxm_check": ns["export_fold"](up(comp_np)),
        "full_compose(round-4 default)": ns["export_fold"](comp_full),
    }
    assert set(got) == {"mean_abs_flow_vox", "folding_pct_exported"}
    assert set(got["mean_abs_flow_vox"]) == set(want_flow)
    for k, v in want_flow.items():
        assert abs(got["mean_abs_flow_vox"][k] - v) <= 1e-3, k
    assert v > 0.05  # the fields are not trivial
    assert set(got["folding_pct_exported"]) == set(want_fold)
    for k, v in want_fold.items():
        assert abs(got["folding_pct_exported"][k] - v) <= 0.01, (k, got, want_fold)


def test_numpy_compose_equals_compose_fields(cascade):
    from multimodal_registration_torch.ops.field import compose_fields

    t1, t2 = cascade["port"]
    sub = cascade["sub"]
    with torch.inference_mode():
        _, w1 = t1.predict_tensors(sub["mov"][None], sub["fx"][None])
        _, w2 = t2.predict_tensors(sub["fx"][None], sub["mov"][None])
        got = compose_fields(w1[0], w2[0] * 3.0).numpy()
    want = cfp.numpy_compose(w1[0].numpy().astype(np.float64),
                             w2[0].numpy().astype(np.float64) * 3.0)
    assert np.abs(got - want).max() <= 1e-4
    jax_np = _jax_scripts_helpers()["numpy_compose"](w1[0].numpy().astype(np.float64),
                                                     w2[0].numpy().astype(np.float64) * 3.0)
    assert np.array_equal(jax_np, want)  # the copy is the JAX script's function


def test_sweep_rows_equal_the_jax_package(cascade):
    import jax
    import jax.numpy as jnp

    from multimodal_registration_tpu.ops.field import compose_fields, smooth_field
    from multimodal_registration_tpu.ops.integrate import integrate_svf
    from multimodal_registration_tpu.ops.resize import rescale_field
    from multimodal_registration_tpu.ops.warp import warp

    sub = cascade["sub"]
    sigmas = (0.0, 1.5)
    rows = css.sweep_rows(*cascade["port"], sub, SUB_LABELS, sigmas, None, emit=_quiet)
    # the JAX script's rows, its own label_dice and interior_fold
    j1, j2 = cascade["jax"]
    mov, fx, lab_np = sub["mov"], sub["fx"], np.asarray(sub["lab"])
    full = SUB_SHAPE
    warp_nearest = jax.jit(lambda v, f: warp(v, f, interp="nearest"))
    ns = _compiled("cascade_smoothing_sweep.py", {"label_dice", "interior_fold"},
                   {"np": np, "jnp": jnp, "mov_lab": sub["mov_lab"], "lab_np": lab_np,
                    "num_labels": SUB_LABELS, "warp_nearest": warp_nearest})
    export_fold = _jax_scripts_helpers()["export_fold"]
    svf1 = np.asarray(j1.model.apply(j1.params, jnp.asarray(mov)[None, ..., None],
                                     jnp.asarray(fx)[None, ..., None])["svf"])[0]
    up = lambda w: rescale_field(w, 2, out_shape=full)  # noqa: E731
    assert [r["sigma_vox_at_svf_grid"] for r in rows] == list(sigmas)
    for sigma, row in zip(sigmas, rows):
        w1 = integrate_svf(smooth_field(jnp.asarray(svf1), sigma, radius=css.RADIUS), 5,
                           payload_dtype=None)
        moved1 = warp(jnp.asarray(mov), up(w1), interp="linear")
        _, w2_b = j2.predict(np.asarray(moved1)[None], fx[None])
        w2 = jnp.asarray(w2_b[0])
        ci, w1_full = compose_fields(w1, w2), np.asarray(up(w1))
        cf = compose_fields(up(w1), up(w2))
        ci_full = np.asarray(up(ci))
        want = {
            "sigma_vox_at_svf_grid": sigma,
            "mean_abs_warp1_vox": float(jnp.abs(w1).mean()),
            "fold_warp1_only": export_fold(w1_full),
            "fold_warp1_interior16": ns["interior_fold"](w1_full),
            "fold_int_compose": export_fold(ci_full),
            "fold_int_compose_interior16": ns["interior_fold"](ci_full),
            "fold_full_compose": export_fold(np.asarray(cf)),
            "dice_int_compose": ns["label_dice"](ci_full),
            "dice_full_compose": ns["label_dice"](np.asarray(cf)),
            "dice_step1_only": ns["label_dice"](w1_full),
        }
        assert list(row) == list(want)
        assert abs(row["mean_abs_warp1_vox"] - want["mean_abs_warp1_vox"]) <= 1e-3
        for k in want:
            if k.startswith("fold"):
                assert abs(row[k] - want[k]) <= 0.01, (sigma, k, row[k], want[k])
            elif k.startswith("dice"):
                assert abs(row[k] - want[k]) <= 0.002, (sigma, k, row[k], want[k])
    assert rows[0]["mean_abs_warp1_vox"] > 0.05
    assert rows[0]["dice_step1_only"] < 1.0


def test_sweep_and_probe_records_have_the_jax_scripts_keys(cascade):
    probe_keys = _dict_key_sets(_tree("cascade_folding_probe.py"))
    sweep_keys = _dict_key_sets(_tree("cascade_smoothing_sweep.py"))
    sub = cascade["sub"]
    got = {"workload": "", "checkpoints": {"model1": "", "model2": ""},
           **cfp.probe(*cascade["port"], sub["fx"], sub["mov"], "cpu")}
    assert frozenset(got) in probe_keys
    assert all(frozenset(v) in probe_keys for v in got.values() if isinstance(v, dict))
    row = css.sweep_rows(*cascade["port"], sub, SUB_LABELS, (0.5,), None, emit=_quiet)[0]
    assert frozenset(row) in sweep_keys
    # the sweep record's keys, as the port's run() builds it (the probe's
    # record: test_quick_probe_and_subject_run_on_the_cpu)
    keys = frozenset({"workload", "backend", "checkpoints", "blur", "rows"})
    assert keys in sweep_keys and keys in _dict_key_sets(ast.parse(open(css.__file__).read()))


def test_quick_probe_and_subject_run_on_the_cpu(capsys):
    out = cfp.main(["--quick", "--device", "cpu"])
    assert out["workload"].startswith("(48, 48, 48)/8 labels, subject idx 1 (sub-02)")
    assert all(v == 0.0 for v in out["folding_pct_exported"].values())  # zero weights
    assert json.loads(capsys.readouterr().out) == out
    assert frozenset(out) in _dict_key_sets(_tree("cascade_folding_probe.py"))
    sub = cfp.subject(0, cfp.train_config(True), "cpu")
    assert sub["fx"].shape == sub["mov"].shape == sub["lab"].shape == (48, 48, 48)
    assert sub["fx"].min() == 0.0 and sub["fx"].max() == 1.0
    assert not np.array_equal(sub["lab"], sub["mov_lab"])  # the moving labels displaced


def test_quick_sweep_runs_on_the_cpu_and_tpu_changes_nothing(monkeypatch):
    rec = css.run(1, (0.0,), "cpu", emit=_quiet, quick=True)
    assert rec["backend"] == "cpu-f32" and rec["checkpoints"]["model1"] == "zero template"
    assert rec["workload"].startswith("(48, 48, 48)/8 labels, subject idx 1 (sub-02)")
    assert [r["sigma_vox_at_svf_grid"] for r in rec["rows"]] == [0.0]
    assert rec["rows"][0]["fold_warp1_only"] == 0.0  # zero weights
    calls = []
    monkeypatch.setattr(css, "run", lambda *a, **k: calls.append((a, k)) or {})
    css.main(["--device", "cpu"])
    css.main(["--device", "cpu", "--tpu"])
    assert calls[0] == calls[1]


@pytest.mark.parametrize("mod, argv", [(ablate, []), (unet_bwd_probe, ["--small"]),
                                       (cfp, []), (cfp, ["--quick"]), (css, []),
                                       (css, ["--tpu"])])
def test_the_studies_run_on_the_gpu_unless_asked_for_the_cpu(mod, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


# ---- the opt-affine rotation study ----------------------------------------------------

def test_rotation_study_reproduces_the_committed_results(tmp_path):
    want = json.load(open(os.path.join(BENCH, "opt_affine_rotation_results.json")))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = oars.main(["--out", str(tmp_path / "r.json")])
    assert json.load(open(tmp_path / "r.json")) == got
    assert [r["case"] for r in got["cases"]] == [r["case"] for r in want["cases"]]
    for g, w in zip(got["cases"], want["cases"]):
        assert set(g) == set(w)
        for k in w:
            if k.startswith("dice"):
                assert abs(g[k] - w[k]) <= 0.002, (g["case"], k)
            elif k.startswith("residual"):
                assert abs(g[k] - w[k]) <= 0.05, (g["case"], k)
    assert set(got["summary"]) == set(want["summary"])
    for k, v in want["summary"].items():
        if isinstance(v, bool):
            assert got["summary"][k] is v, k
        else:
            assert abs(got["summary"][k] - v) <= (0.002 if "dice" in k else 0.05), k
    assert got["summary"]["centermass_recovers_translation"] is False  # copied, not "fixed"
    assert json.loads(out.getvalue()[out.getvalue().index("{\n"):]) == got["summary"]


@pytest.mark.parametrize("case", oars.CASES[:4], ids=[c[0] for c in oars.CASES[:4]])
def test_fallback_fields_equal_the_jax_package(case):
    from multimodal_registration_tpu.pipeline import segment as jseg

    from multimodal_registration_torch.pipeline import segment as tseg

    _, ang, axis, shift = case
    fx = oars.make_tube((48, 48, 64), radius=4.0, seed=3)
    mov = oars.rigid_transform(fx, ang, axis, [s / 2 for s in shift])
    for name in ("centermass_affine_field", "rigid_affine_field"):
        got, want = getattr(tseg, name)(fx, mov), getattr(jseg, name)(fx, mov)
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5, name
    assert oars.dice(fx, oars.apply_field_host(mov, tseg.centermass_affine_field(fx, mov))) \
        >= oars.dice(fx, mov)
