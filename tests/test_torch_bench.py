"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

  * its flags, defaults, choices, ``SHAPE``, ``ARCHS``, model configuration
    and ``measure`` defaults equal ``bench.py``'s, read from ``bench.py``'s
    syntax tree (importing it would import JAX and run its cache setup);
  * the w256 parameters and int8 scales it loads equal the JAX package's
    reading of the same files;
  * ``measure`` and ``main`` run at a tiny shape through the plain versions
    and print ``bench.py``'s lines in ``bench.py``'s order;
  * ``.bench_baseline.json`` is only read; without a GPU and without
    ``--device cpu`` the script exits non-zero and prints no line.
"""

import ast
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_registration_tpu.models import quantize as jquant
from multimodal_registration_tpu.models import vxm_dense as jvd
from multimodal_registration_tpu.train.trainer import _unflatten_params
from multimodal_registration_torch.models.weights import params_from_jax, quant_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

TINY = (16, 16, 16)
KEYS = ["metric", "value", "unit", "vs_baseline"]


@pytest.fixture(scope="module")
def ref():
    """What ``bench.py`` defines, from its syntax tree: ``SHAPE``, ``ARCHS``,
    the ``measure_tpu`` defaults, the model config call, the flags of
    ``main`` and its default order of lines."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read(), "bench.py")
    out = {}

    def value(node, names):
        return eval(compile(ast.Expression(node), "bench.py", "eval"),
                    {"__builtins__": {}, **names})

    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id in ("SHAPE", "ARCHS"):
            out[node.targets[0].id] = value(node.value, {"dict": dict})
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    m = funcs["measure_tpu"].args
    out["measure"] = {a.arg: value(d, out) for a, d in zip(m.args[-len(m.defaults):], m.defaults)}
    call = next(n for n in ast.walk(funcs["measure_tpu"])
                if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "VxmConfig")
    out["config"] = {k.arg: k.value for k in call.keywords}
    flags = {}
    for n in ast.walk(funcs["main"]):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            flags[n.args[0].value] = (
                value(kw["default"], {}) if "default" in kw else None,
                value(kw["choices"], {"sorted": sorted, "ARCHS": out["ARCHS"]})
                if "choices" in kw else None,
                kw["type"].id if "type" in kw else None)
    out["flags"] = flags
    specs = next(n for n in ast.walk(funcs["main"])
                 if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "specs")
    out["specs"] = value(specs.value, {})
    return out


def _metric(ref, arch, quantize):
    return ref["ARCHS"][arch]["metric"] + (f"_{quantize}" if quantize else "")


def test_flags_shape_archs_and_models_equal_bench_py(ref):
    assert bench_torch.SHAPE == ref["SHAPE"] == (192, 192, 192)
    assert bench_torch.ARCHS == ref["ARCHS"]
    flags = {a.option_strings[0]: (a.default, a.choices, getattr(a.type, "__name__", None))
             for a in bench_torch.build_parser()._actions if a.option_strings[0] != "-h"}
    assert flags.pop("--device") == (None, None, None)  # the one flag bench.py has not
    assert flags == ref["flags"]
    params = inspect.signature(bench_torch.measure).parameters
    assert {k: params[k].default for k in ref["measure"]} == ref["measure"]
    assert list(params) == [*ref["measure"], "device"]
    for arch in ref["ARCHS"]:
        for quantize in ("", "int8"):
            want = {k: eval(compile(ast.Expression(v), "bench.py", "eval"),
                            {"a": ref["ARCHS"][arch], "quantize": quantize})
                    for k, v in ref["config"].items()}
            got = bench_torch.model_config(arch, quantize)
            assert {k: getattr(got, k) for k in want} == want
            # every field the two packages' configs share, defaults included
            jcfg = jvd.VxmConfig(**want)
            common = ({f.name for f in dataclasses.fields(got)}
                      & {f.name for f in dataclasses.fields(jcfg)})
            assert len(common) == 9
            assert {k: getattr(got, k) for k in common} == {k: getattr(jcfg, k) for k in common}


def test_w256_params_and_scales_equal_the_jax_packages():
    cfg = bench_torch.model_config("infer256", "int8")
    params, scales, note = bench_torch._load_w256(cfg)
    assert note == "trained w256 checkpoint + quant sidecar"
    jcfg = jvd.VxmConfig(enc=cfg.enc, dec=cfg.dec, quantize="int8")
    with np.load(bench_torch.W256_CKPT) as z:
        variables = _unflatten_params(jvd.params_template(jcfg), dict(z))
    want = params_from_jax(variables, cfg)
    assert set(params) == set(want) and len(params) == 22
    for k, v in want.items():
        assert torch.equal(params[k], v), k
    jscales = quant_from_jax(jquant.load_scales(bench_torch.W256_CKPT + ".quant.json"))
    assert len(scales) == 9 and scales == jscales


@pytest.mark.parametrize("arch, quantize", [("train64", ""), ("infer256", "int8")])
def test_measure_on_the_cpu_gives_a_positive_rate(arch, quantize, capsys):
    rate = bench_torch.measure(TINY, iters=1, batch=1, arch=arch, blocks=1, quantize=quantize,
                               device="cpu")
    assert rate > 0 and np.isfinite(rate)
    err = capsys.readouterr().err
    assert "# block 0:" in err and "# launches per forward:" in err
    assert ("trained w256 checkpoint + quant sidecar" in err) == (arch == "infer256")


def test_main_prints_bench_py_lines_in_order_and_only_reads_the_baseline(ref, monkeypatch,
                                                                          capsys, tmp_path):
    before = open(bench_torch.BASELINE_CACHE, "rb").read()
    monkeypatch.setattr(bench_torch, "SHAPE", TINY)
    assert bench_torch.main(["--device", "cpu", "--iters", "1", "--blocks", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(line) for line in out]
    assert len(out) == 3
    assert [d["metric"] for d in lines] == [_metric(ref, a, q) for a, q in ref["specs"]] == [
        "registered_192cube_enc256_pairs_per_sec",
        "registered_192cube_enc256_pairs_per_sec_int8",
        "registered_192cube_vol_pairs_per_sec"]
    base = json.loads(before)
    for d, (arch, _) in zip(lines, ref["specs"]):
        assert list(d) == KEYS and d["unit"] == "pairs/s" and d["value"] > 0
        assert d["vs_baseline"] == pytest.approx(
            d["value"] / base[ref["ARCHS"][arch]["baseline_key"]], rel=0.01, abs=0.01)
    assert open(bench_torch.BASELINE_CACHE, "rb").read() == before
    assert {k: base[k] for k in ("tf_cpu_pairs_per_sec_192", "tf_cpu_pairs_per_sec_192_enc256")
            } == pytest.approx({"tf_cpu_pairs_per_sec_192": 0.07874,
                                "tf_cpu_pairs_per_sec_192_enc256": 0.0021356}, rel=1e-4)

    # one line with --arch, and vs_baseline 1.0 where the baseline has no key
    missing = tmp_path / "baseline.json"
    missing.write_text(json.dumps({"tf_cpu_pairs_per_sec_192_enc256": 0.0021356}))
    monkeypatch.setattr(bench_torch, "BASELINE_CACHE", str(missing))
    assert bench_torch.main(["--device", "cpu", "--iters", "1", "--blocks", "1",
                             "--arch", "train64"]) == 0
    captured = capsys.readouterr()
    (line,) = captured.out.splitlines()
    assert json.loads(line)["metric"] == "registered_192cube_vol_pairs_per_sec"
    assert json.loads(line)["vs_baseline"] == 1.0
    assert "no tf_cpu_pairs_per_sec_192 in baseline.json: vs_baseline 1.0" in captured.err
    assert bench_torch.get_baseline("train64") is None
    assert bench_torch.get_baseline("infer256") == 0.0021356
    monkeypatch.setattr(bench_torch, "BASELINE_CACHE", str(tmp_path / "absent.json"))
    assert bench_torch.vs_baseline(3.0, "infer256") == 1.0
    assert not (tmp_path / "absent.json").exists()


def test_without_a_gpu_the_script_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), "--arch",
                        "train64"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
