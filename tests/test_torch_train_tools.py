"""The port's training-step measurement tools on the CPU, against the JAX scripts.

``multimodal_registration_torch/tools/``: ``roofline``, ``train_bench``,
``train_breakdown``, ``bwd_breakdown``, ``synth_breakdown``,
``train_profile``, ``train_sol`` and ``fwd_breakdown``, the counterparts of
the ``benchmarks/`` scripts of the same names.

  * each tool's flags, defaults, row names and JSON keys equal the JAX
    script's, read from its syntax tree (importing the scripts would import
    JAX and set up its cache); every port tool adds ``--device`` and
    ``--out``; the JAX ``train_breakdown.py``'s ``--zline`` and
    ``--zline-compose`` (TPU layouts, ROADMAP item 17) exit with a message,
    and ``bwd_breakdown.py``'s ``tail_error`` (its remote compiler's failure)
    has no counterpart;
  * ``tools/roofline.py``'s FLOPs equal ``benchmarks/roofline.py``'s (which
    imports no JAX, and runs here with its rounding switched off) per
    component and in total, exactly, at (192^3, w64), (192^3, w256) and
    (160, 160, 192);
  * each timing tool runs once through its ``main`` at ``--small`` size
    (``fwd_breakdown`` at 16^3), every measured row positive and every
    derived row equal to its formula (float64 arithmetic on the same floats:
    exact, or 1e-9 relative where a sum is formed in another order);
  * ``train_bench``'s ``final_loss`` after N steps equals that of N direct
    calls of ``Trainer.train_step_banked`` on the same generator seed
    (float32, rtol 1e-6).
"""

import ast
import contextlib
import importlib.util
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from multimodal_registration_torch.tools import (
    bwd_breakdown, fwd_breakdown, roofline, synth_breakdown, train_bench, train_breakdown,
    train_profile, train_sol)
from multimodal_registration_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
PORT_ONLY = {"--device", "--out"}  # the flags every port tool adds


def _tree(name):
    path = os.path.join(BENCH, name)
    return ast.parse(open(path).read(), path)


def _funcs(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _dashed_constants(tree):
    """Every string constant of the script that is a flag (``--...``)."""
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith("--") and " " not in n.value}


def _argparse_flags(tree):
    """``{flag: (default, choices)}`` of the script's ``add_argument`` calls."""
    out = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            out[n.args[0].value] = (
                ast.literal_eval(kw["default"]) if "default" in kw else None,
                ast.literal_eval(kw["choices"]) if "choices" in kw else None)
    return out


def _port_flags(parser):
    return {a.option_strings[0]: (a.default, tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.option_strings and a.option_strings[0] != "-h"}


def _main_default(tree):
    """N of the script's ``main(int(argv[0]) if argv else N, ...)``."""
    for n in ast.walk(tree):
        if (isinstance(n, ast.IfExp) and isinstance(n.orelse, ast.Constant)
                and isinstance(n.body, ast.Call) and getattr(n.body.func, "id", None) == "int"):
            return n.orelse.value
    raise AssertionError("no positional default found")


def _subscript_keys(tree, name):
    """Constant keys ``name["..."]`` assigned in the script, and the keys of
    the dict literal first assigned to ``name``."""
    keys = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if (isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == name
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
                if getattr(t, "id", None) == name and isinstance(n.value, ast.Dict):
                    keys |= {k.value for k in n.value.keys if isinstance(k, ast.Constant)}
    return keys


def _dumped_dict_keys(tree):
    """The key sets of the dict literals the script passes to ``json.dumps``."""
    return [tuple(k.value for k in n.args[0].keys) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "dumps"
            and n.args and isinstance(n.args[0], ast.Dict)]


def _lines(fn, *args):
    """``fn(*args)``'s return value and its stdout's JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        res = fn(*args)
    return res, [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]


# ---- roofline --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_roofline():
    """``benchmarks/roofline.py`` with its rounding switched off."""
    spec = importlib.util.spec_from_file_location("jax_roofline",
                                                  os.path.join(BENCH, "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.round = lambda x, n=None: x  # the module's lookup finds this before the builtin

    def run(argv):
        saved = sys.argv
        sys.argv = ["roofline.py", *argv]
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                mod.main()
        finally:
            sys.argv = saved
        return json.loads(out.getvalue())
    return run


@pytest.mark.parametrize("argv", [[], ["--width"], ["160", "160", "192"]])
def test_roofline_flops_equal_the_jax_scripts(jax_roofline, argv):
    want = jax_roofline(argv)
    shape, width = roofline.parse_argv(argv)
    comps = roofline.components(shape, width)
    assert list(comps) == list(want["components"])
    for name, c in comps.items():
        assert c["flops"] / 1e9 == want["components"][name]["gflop"], name
    total = sum(c["flops"] for k, c in comps.items() if k != "rescale")
    assert total / 1e9 == want["total"]["gflop"]
    doc = roofline.roofline(shape, width)
    assert doc["shape"] == want["shape"] == list(shape)
    assert {k: set(v) for k, v in doc.items() if isinstance(v, dict)} == {
        "components": set(want["components"]), "total": set(want["total"])}
    assert all(set(v) == {"gflop", "mb", "sol_ms"} for v in doc["components"].values())


def test_roofline_bytes_and_peaks_follow_the_least_traffic_rule():
    shape = (192, 192, 192)
    comps = roofline.components(shape, 64)
    vox, hv = math.prod(shape), math.prod(s // 2 for s in shape)
    # enc_0 writes only the pooled tensor (K1); its inputs and weights read once
    assert comps["enc_0@192"]["bytes"] == (vox * 2 + hv * 64) * 2 + (27 * 2 * 64 + 64) * 2
    # K2's fused step: the float32 field read and written, five times
    assert comps["integrate_5steps"]["bytes"] == 5 * hv * 3 * 4 * 2
    # K3: moving image read, moved image written, the half-res field read
    assert comps["moved_warp"]["bytes"] == vox * 4 * 2 + hv * 3 * 4
    assert comps["flow_head"]["peak"] == roofline.PEAK_F32_FLOPS == 67e12
    assert comps["dec_3@96"]["peak"] == roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.PEAK_HBM == 3.35e12
    c = comps["dec_3@96"]
    assert roofline.sol_ms(c) == max(c["flops"] / 989e12, c["bytes"] / 3.35e12) * 1e3
    doc = roofline.roofline(shape, 64)["total"]
    assert doc["sol_ms_flops"] == pytest.approx(
        sum(c["flops"] / c["peak"] for k, c in comps.items() if k != "rescale") * 1e3, rel=1e-6)
    assert doc["sol_ms_hbm"] == pytest.approx(
        sum(c["bytes"] for c in comps.values()) / 3.35e12 * 1e3, rel=1e-6)
    assert "TPU" not in open(roofline.__file__).read().split('"""')[2]  # no TPU constant


# ---- train_bench -----------------------------------------------------------------

def test_train_bench_flags_and_line_equal_the_jax_scripts():
    tree = _tree("train_bench.py")
    flags = _port_flags(train_bench.build_parser())
    assert {k: v for k, v in flags.items() if k not in PORT_ONLY} == _argparse_flags(tree)
    assert set(flags) - set(_argparse_flags(tree)) == PORT_ONLY
    keys = [k for k in _dumped_dict_keys(tree) if "metric" in k]
    assert keys == [train_bench.KEYS]
    fmt = next(n.left.value for n in ast.walk(tree)
               if isinstance(n, ast.BinOp) and isinstance(n.left, ast.Constant)
               and str(n.left.value).startswith("synthmorph_train"))
    for batch, width in ((1, 0), (2, 0), (1, 256)):
        assert train_bench.metric_name(batch, width) == fmt % (
            batch, f"_w{width}" if width else "")
    d = next(n.value for n in ast.walk(_funcs(tree)["main"])
             if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "d")
    want = {k.arg: ast.literal_eval(k.value) for k in d.keywords if k.arg != "batch_size"}
    cfg = train_bench.train_config(1)
    assert {k: getattr(cfg, k) for k in want} == want == dict(
        in_shape=[160, 160, 192], num_labels=26, zero_borders_maps=True, epochs=1)
    assert cfg.enc == [64] * 4 and train_bench.train_config(1, 256).dec == [256] * 6
    for batch, k6 in ((1, 3), (2, 5)):
        trainer = Trainer(train_bench.train_config(batch), device="cpu")
        assert trainer.step_launches()["warp_labels_soft_hard"] == k6


def test_train_bench_final_loss_equals_direct_steps(capsys):
    """N = 1 warm-up + 2 blocks x 2 steps at 16^3, 4 labels, enc/dec 4."""
    kw = dict(shape=(16, 16, 16), num_labels=4)
    rec = train_bench.run(iters=2, batch=2, width=4, blocks=2, device="cpu", **kw)
    assert rec["metric"] == "synthmorph_train_steps_per_sec_16x16x16_b2_w4"
    assert rec["value"] == 1.0 / rec["sec_per_step"] > 0
    assert rec["sec_per_step"] == min(rec["blocks_s"]) and len(rec["blocks_s"]) == 2
    trainer, bank, si, ti, gen = train_bench.setup(
        train_bench.train_config(2, 4, kw["shape"], kw["num_labels"]), "cpu")
    for _ in range(5):
        aux = trainer.train_step_banked(gen, bank, si, ti)
    np.testing.assert_allclose(rec["final_loss"], float(aux["loss"]), rtol=1e-6)
    err = capsys.readouterr().err
    assert "# block 1:" in err and "# launches per step:" in err


def test_train_bench_main_prints_one_line(monkeypatch, tmp_path):
    monkeypatch.setattr(train_bench, "SHAPE", (16, 16, 16))
    monkeypatch.setattr(train_bench, "NUM_LABELS", 4)
    rec, lines = _lines(train_bench.main, ["--iters", "1", "--width", "4", "--device", "cpu",
                                           "--out", str(tmp_path / "tb.json")])
    assert len(lines) == 1 and tuple(lines[0]) == train_bench.KEYS
    assert lines[0]["unit"] == "steps/s" and lines[0]["final_loss"] == rec["final_loss"]
    assert json.load(open(tmp_path / "tb.json"))["final_loss"] == rec["final_loss"]
    with pytest.raises(ValueError, match="never write under"):
        train_bench.main(["--iters", "1", "--width", "4", "--device", "cpu",
                          "--out", os.path.join(BENCH, "x.json")])


# ---- train_breakdown ---------------------------------------------------------------

def test_train_breakdown_flags_and_rows_equal_the_jax_scripts():
    tree = _tree("train_breakdown.py")
    flags = set(_port_flags(train_breakdown.build_parser()))
    assert flags - PORT_ONLY == _dashed_constants(tree)
    assert set(train_breakdown.ITEM17) == {"--zline", "--zline-compose"}
    assert train_breakdown.build_parser().get_default("iters") == _main_default(tree) == 6
    keys = _subscript_keys(tree, "res")
    assert keys == {"zline", "zline_compose", "svf_int_res", "grad_res",
                    *train_breakdown.ROWS, *train_breakdown.DERIVED}
    for flag in train_breakdown.ITEM17:
        with pytest.raises(SystemExit, match="item 17"):
            train_breakdown.main([flag, "--device", "cpu"])


def test_train_breakdown_runs_small_and_derives_its_rows():
    res, lines = _lines(train_breakdown.main, ["1", "--small", "--svf2", "--device", "cpu"])
    assert [list(ln) for ln in lines[:6]] == [[r] for r in train_breakdown.ROWS]
    assert lines[-1] == res and res["svf_int_res"] == 2 and res["grad_res"] == 1
    assert all(res[k] > 0 for k in train_breakdown.ROWS)
    assert res["bwd_attributed_ms"] == res["fwd_bwd_ms"] - res["fwd_ms"]
    assert res["loss_fwd_attributed_ms"] == res["fwd_ms"] - res["synth_ms"]
    assert res["model_bwd_ms"] == res["model_fwd_bwd_ms"] - res["model_fwd_ms"]
    assert res["loss_tail_bwd_ms"] == res["bwd_attributed_ms"] - res["model_bwd_ms"]
    assert train_breakdown.breakdown_config(True, grad_res=2).grad_res == 2
    wide = train_breakdown.breakdown_config(False, width=256)  # chip_smoke.py's w256 rows
    assert (wide.enc, wide.dec, wide.in_shape) == ([256] * 4, [256] * 6, [160, 160, 192])


# ---- bwd_breakdown -----------------------------------------------------------------

def test_bwd_breakdown_runs_small_with_the_jax_scripts_keys():
    tree = _tree("bwd_breakdown.py")
    assert set(_port_flags(bwd_breakdown.build_parser())) - PORT_ONLY == _dashed_constants(tree)
    assert bwd_breakdown.build_parser().get_default("iters") == _main_default(tree) == 8
    # the port's own component: the training loss's fused Dice
    own = {f"onehot_dice_{k}" for k in ("fwd_ms", "fwd_bwd_ms", "bwd_ms")}
    want = _subscript_keys(tree, "res") - {"tail_error"} | own
    res, lines = _lines(bwd_breakdown.main, ["1", "--small", "--device", "cpu"])
    assert set(res) == want and lines[-1] == res and res["shape"] == [32, 32, 48]
    assert {k.rsplit("_", 3)[0] for k in want - own if k.endswith("_bwd_ms")} >= set(
        bwd_breakdown.COMPONENTS) - {"onehot_dice"}
    assert bwd_breakdown.COMPONENTS.index("onehot_dice") == bwd_breakdown.COMPONENTS.index(
        "onehot") + 1
    for c in bwd_breakdown.COMPONENTS:
        assert res[f"{c}_fwd_ms"] > 0 and res[f"{c}_fwd_bwd_ms"] > 0
        assert res[f"{c}_bwd_ms"] == res[f"{c}_fwd_bwd_ms"] - res[f"{c}_fwd_ms"]


# ---- synth_breakdown ---------------------------------------------------------------

def test_synth_breakdown_runs_small_with_the_jax_scripts_stages():
    tree = _tree("synth_breakdown.py")
    names = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                 if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "names")
    assert tuple(names) == synth_breakdown.STAGES
    fstrings = {ast.unparse(n.targets[0].slice) for n in ast.walk(tree)
                if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
                and isinstance(n.targets[0].slice, ast.JoinedStr)}
    assert fstrings == {"f'cum_{name}_ms'", "f'delta_{name}_ms'"}
    assert set(_port_flags(synth_breakdown.build_parser())) - PORT_ONLY == _dashed_constants(tree)
    assert synth_breakdown.build_parser().get_default("iters") == _main_default(tree) == 8
    want = _subscript_keys(tree, "res") | {f"{p}_{s}_ms" for s in names for p in ("cum", "delta")}
    res, lines = _lines(synth_breakdown.main, ["1", "--small", "--device", "cpu"])
    assert set(res) == want and res["labels"] == 8
    assert [list(ln) for ln in lines[:8]] == [[s, "delta"] for s in names]
    prev = 0.0
    for s in names:
        assert res[f"cum_{s}_ms"] > 0
        assert res[f"delta_{s}_ms"] == res[f"cum_{s}_ms"] - prev
        prev = res[f"cum_{s}_ms"]
    assert res["aug_pair_ms"] > 0 and res["synth_pair_ms"] > 0


# ---- train_profile -----------------------------------------------------------------

def test_train_profile_runs_small_with_the_jax_scripts_keys(tmp_path):
    tree = _tree("train_profile.py")
    assert set(_port_flags(train_profile.build_parser())) - PORT_ONLY == _dashed_constants(tree)
    assert train_profile.build_parser().get_default("steps") == _main_default(tree) == 3
    want = _dumped_dict_keys(tree)
    rec, lines = _lines(train_profile.run, 1, True, "cpu", print, str(tmp_path), 8)
    assert not rec["on_device"]  # the host operators' self time on the CPU
    got = {tuple(lines[0]), tuple(lines[1]), tuple(lines[-1])}
    assert got == set(want) == {("lanes",), ("op", "ms_per_step", "count", "cat"),
                                ("category_ms_per_step", "total_device_ms_per_step", "trace_dir")}
    assert all(tuple(ln) == ("op", "ms_per_step", "count", "cat") for ln in lines[1:-1])
    cats = rec["category_ms_per_step"]
    assert {"conv", "elementwise", "copy"} <= set(cats) and all(v >= 0 for v in cats.values())
    assert sum(cats.values()) == pytest.approx(rec["total_device_ms_per_step"], rel=1e-9)
    assert rec["trace_dir"] == str(tmp_path)


def test_train_profile_categories_and_self_time():
    c = train_profile.categorize
    assert c("void (anonymous namespace)::pool_bwd_kernel<__nv_bfloat16>(...)") == "K4"
    assert c("void (anonymous namespace)::self_warp_add_bwd_kernel<true>(float const*)") == "K5"
    assert c("void (anonymous namespace)::warp_kernel<float>(...)") == "K2"
    # the Dice entries of K6 and K7 count as their kernels
    assert c("void (anonymous namespace)::warp_labels_dice_fwd_kernel<unsigned char>(...)") == "K6"
    assert c("(anonymous namespace)::warp_labels_dice_reduce_kernel(double const*, float*)") == "K6"
    assert c("void (anonymous namespace)::warp_labels_dice_bwd_kernel<unsigned char>(...)") == "K7"
    assert c("void (anonymous namespace)::warp_labels_kernel<int>(...)") == "K6"
    assert c("void (anonymous namespace)::warp_labels_bwd_kernel<int>(...)") == "K7"
    assert c("void tc::conv3_lrelu_pool_wgmma_kernel<4>(...)") == "K1"
    assert c("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc") == "conv"
    assert c("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MaxOps>>") \
        == "reduce"
    assert c("void at::native::vectorized_elementwise_kernel<4, clamp_min_scalar_kernel>") \
        == "elementwise"
    assert c("Memcpy DtoD (Device -> Device)") == "copy"
    assert c("void at::native::index_elementwise_kernel<128, 4>") == "gather/scatter"
    ev = [dict(name="a", ts=0, dur=10, pid=1, tid=1), dict(name="b", ts=2, dur=3, pid=1, tid=1),
          dict(name="c", ts=6, dur=2, pid=1, tid=1), dict(name="d", ts=0, dur=4, pid=1, tid=2)]
    assert sorted(train_profile._self_times(ev)) == [
        ("a", 0.005), ("b", 0.003), ("c", 0.002), ("d", 0.004)]


# ---- train_sol ---------------------------------------------------------------------

def test_train_sol_runs_small_with_the_jax_scripts_rows(tmp_path):
    tree = _tree("train_sol.py")
    assert set(_port_flags(train_sol.build_parser())) - PORT_ONLY == _dashed_constants(tree)
    L = 8
    stages = [eval(compile(ast.Expression(n.args[0]), "train_sol.py", "eval"), {"L": L})
              for n in ast.walk(_funcs(tree)["main"])
              if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "add"]
    out, _ = _lines(train_sol.main, ["--small", "--iters", "1", "--device", "cpu",
                                     "--out", str(tmp_path / "sol.json")])
    # the JAX script's rows, then the port's own: the training loss's fused Dice
    assert [r["stage"] for r in out["rows"]] == stages + [train_sol.DICE_ROW]
    out_keys = next(n for n in ast.walk(_funcs(tree)["main"])
                    if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "out")
    assert list(out) == [k.value for k in out_keys.value.keys]
    assert (out["workload"], out["labels"], out["svf_int_res"]) == ([32, 32, 48], L, 4)
    assert json.load(open(tmp_path / "sol.json")) == out
    for r in out["rows"]:
        assert list(r) == ["stage", "ms", "floor_ms", "floor"]
        assert r["ms"] > 0 and r["floor_ms"] > 0
    V = 32 * 32 * 48
    rows = {r["stage"]: r for r in out["rows"]}
    assert rows["label warp (soft+hard, packed)"]["floor_ms"] == pytest.approx(
        V * (L * 4 + 4 + 12 + 4) / 3.35e12 * 1e3, rel=1e-12)
    assert rows[train_sol.DICE_ROW]["floor_ms"] == pytest.approx(
        V * (L * 4 + 12 + 4 + 4 + 12 + 4 + 12) / 3.35e12 * 1e3, rel=1e-12)
    assert rows["svf integrate (5 sq, /4 grid)"]["floor_ms"] == pytest.approx(
        5 * (V // 64) * 3 * 4 * 2 / 3.35e12 * 1e3, rel=1e-12)
    fwd = rows["model fwd (U-Net+int, to warp)"]["floor_ms"]
    assert fwd == pytest.approx(train_sol.model_floor_s((32, 32, 48)) * 1e3, rel=1e-12)
    assert rows["model fwd+bwd (grad wrt params)"]["floor_ms"] == pytest.approx(3 * fwd,
                                                                              rel=1e-12)


# ---- fwd_breakdown -----------------------------------------------------------------

def test_fwd_breakdown_flags_rows_and_a_tiny_run():
    tree = _tree("fwd_breakdown.py")
    flags = _port_flags(fwd_breakdown.build_parser())
    assert {k: v for k, v in flags.items() if k not in PORT_ONLY} == {
        k: (d, tuple(c) if c else None) for k, (d, c) in _argparse_flags(tree).items()}
    outputs = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                   if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "outputs")
    assert fwd_breakdown.ROWS == (*[f"upto_{k}_ms" for k in outputs], "full_predict_ms")
    for arch, width in (("train", 64), ("infer256", 256)):
        res, lines = _lines(fwd_breakdown.run, arch, 1, (16, 16, 16), "cpu")
        assert tuple(res) == fwd_breakdown.ROWS and all(v > 0 for v in res.values())
        assert [list(ln) for ln in lines[:-1]] == [[r] for r in fwd_breakdown.ROWS[:-1]]
    model = fwd_breakdown.arch_model("infer256", "cpu")
    assert model.cfg.enc == (256,) * 4 and model.cfg.dec == (256,) * 6
    with np.load(fwd_breakdown.W256_CKPT) as z:  # the checkpoint's weights, not an init
        w = z["params/flow/kernel"]
    assert torch.equal(model.flow.weight.detach(),
                       torch.as_tensor(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))))


@pytest.mark.parametrize("tool, argv", [
    (train_bench, []), (train_breakdown, ["--small"]), (bwd_breakdown, ["--small"]),
    (synth_breakdown, ["--small"]), (train_profile, ["--small"]), (train_sol, ["--small"]),
    (fwd_breakdown, [])])
def test_tools_run_on_the_gpu_unless_asked_for_the_cpu(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def test_smoke_in_turns_train_mode_runs_the_tools_flags():
    """``smoke_in_turns --train`` starts ``train_bench`` and ``train_profile``
    with flags their parsers take, phase 13a's configurations among them."""
    from multimodal_registration_torch.tools import smoke_in_turns

    parsers = {f"multimodal_registration_torch.tools.{m.__name__.rsplit('.', 1)[1]}":
               m.build_parser() for m in (train_bench, train_profile)}
    runs = {}
    for name, argv in smoke_in_turns.TRAIN:
        assert argv[0] == "-m"
        runs[name] = parsers[argv[1]].parse_args(argv[2:])
    assert [(a.batch, a.width, a.iters, a.blocks) for k, a in runs.items()
            if k.startswith("train_bench")] == [(1, 0, 6, 3), (2, 0, 6, 3), (1, 256, 6, 3)]
    assert runs["train_profile"].steps == 3
