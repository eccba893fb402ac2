"""The port's last probes on the CPU against the JAX scripts and flax.

``multimodal_registration_torch/tools/``: ``svf4_learn_probe``, ``conv_probe``
and ``pair_interleave_probe``, the counterparts of the ``benchmarks/`` scripts
of the same names.

  * flags, defaults, the svf4 arms' configurations (the JAX ``main``'s first
    statements, run for ``small`` false and true), the seven conv cases and
    the pair probe's result keys equal the JAX scripts', read from their
    syntax trees (importing them would import JAX and start its cache); the
    port adds ``--device`` and ``--out``;
  * svf4: the JAX script's ``main``, compiled from its source and run with
    stand-ins for what needs JAX training (its ``Trainer``, the synthesis, the
    label maps and the PRNG keys; the JAX package's ``TrainConfig``,
    ``engine_config_from``, NMI and warp are real), against the port's probe
    with the same stand-ins (its ``Trainer``, ``learn_check``'s synthesis and
    maps). Both models give zero flow, both syntheses draw a pair's images
    from numpy on the draw's place in the schedule (the JAX pair ``s`` keys
    its two syntheses from ``1000 + s``; the port draws all six from one
    generator seeded 1000). Over 450 steps with an evaluation every 200 and
    after the last: the arms' configurations, the maps made once (seed 0),
    the six syntheses made once before either arm on the engine at
    ``svf_int_res`` 2 and shared, each step's map indices and training seed,
    the steps at which the model is evaluated, the record and the printed
    lines (but ``sec_per_step``) are equal, exactly;
  * svf4: one real run on the CPU at 16^3, 4 labels, enc/dec [4] (the
    function's ``over``), 2 steps an arm: both arms, the record's keys, the
    pairs shared, the configurations differing in ``svf_int_res`` only;
  * conv: :func:`conv_probe.conv` against flax's ``nn.Conv`` (``SAME``) on the
    same weights at 8x8x7 (even and odd sizes), strides 1 and 2: float32 within 1e-5,
    bf16 within 1 bf16 ulp of max|out| (a float32 sum in another order,
    rounded once); the FLOP count is the script's;
  * pair interleave at 16^3, enc/dec [4]: the guard (the staged ``U`` -> ``T``
    against ``model(...)``), each two-pair arm's outputs equal to the single
    pair's (the staged arms exactly; the batch of 2 within 1e-6 on fields of
    half a voxel: oneDNN sums a batch's float32 head in another order), the
    printed lines and the record's keys;
  * each tool raises without a card unless asked for the CPU.
"""

import ast
import dataclasses
import json
import os
import re
import time
import types

import numpy as np
import pytest
import torch

from multimodal_registration_torch.models.vxm_dense import VxmConfig
from multimodal_registration_torch.tools import conv_probe as cp
from multimodal_registration_torch.tools import learn_check as lc
from multimodal_registration_torch.tools import pair_interleave_probe as pip
from multimodal_registration_torch.tools import svf4_learn_probe as s4

from _torch_port import bf16_ulp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
TINY = dict(in_shape=[16, 16, 16], num_labels=4, enc=[4] * 4, dec=[4] * 6)
TINY_VXM = VxmConfig(enc=(4,) * 4, dec=(4,) * 6)


def _source(name):
    path = os.path.join(BENCH, name)
    return path, open(path).read()


def _tree(name):
    path, src = _source(name)
    return ast.parse(src, path)


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _port_flags(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: a.default
            for a in parser._actions if a.dest != "help"}


# ---- flags, defaults, cases and keys -------------------------------------------------

def test_svf4_flags_defaults_and_configs_equal_the_jax_scripts():
    from multimodal_registration_tpu.train.config import TrainConfig as JaxTrainConfig

    path, src = _source("svf4_learn_probe.py")
    tree = ast.parse(src, path)
    main = _function(tree, "main")
    assert [ast.literal_eval(d) for d in main.args.defaults] == [3000, False, 1000]
    guard = [n for n in tree.body if isinstance(n, ast.If)][-1]  # if __name__ == "__main__"
    steps, every = (n for n in ast.walk(guard) if isinstance(n, ast.IfExp))
    assert ast.literal_eval(steps.orelse) == 3000
    assert (ast.literal_eval(every.body), ast.literal_eval(every.orelse)) == (
        s4.SMALL["eval_every"], s4.FULL["eval_every"]) == (200, 1000)
    assert "--small" in {n.value for n in ast.walk(guard) if isinstance(n, ast.Constant)}
    assert _port_flags(s4.build_parser()) == {
        "steps": 3000, "--small": False, "--device": None, "--out": None}
    # main's first statements: shape, L and the base configuration
    first = main.body[:3]
    assert [n.targets[0].id for n in first] == ["shape", "L", "base"]
    for small in (False, True):
        ns = {"small": small}
        exec(compile(ast.Module(first, []), path, "exec"), ns)
        for r in s4.ARMS:
            want = JaxTrainConfig.from_dict(dict(ns["base"], svf_int_res=r))
            assert dataclasses.asdict(s4.probe_config(small, r)) == dataclasses.asdict(want)


def test_conv_cases_flops_and_flags_equal_the_jax_scripts():
    tree = _tree("conv_probe.py")
    cases = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "cases")
    assert tuple(ast.literal_eval(cases.value)) == cp.CASES
    assert "out_vox * 27 * cin * cout * 2" in ast.unparse(_function(tree, "time_conv"))
    for _, shape, cin, cout, stride in cp.CASES:
        out_vox = int(np.prod([s // stride for s in shape]))
        assert cp.flops(shape, cin, cout, stride) == out_vox * 27 * cin * cout * 2
    assert _port_flags(cp.build_parser()) == {"--device": None, "--out": None}
    assert cp.PEAK_TFLOPS == 989.0


def test_pair_interleave_keys_and_flags_equal_the_jax_scripts():
    tree = _tree("pair_interleave_probe.py")
    keys = [n.slice.value for n in ast.walk(_function(tree, "main"))
            if isinstance(n, ast.Subscript) and getattr(n.value, "id", None) == "results"
            and isinstance(n.slice, ast.Constant) and isinstance(n.ctx, ast.Store)]
    assert keys == [*pip.ARMS, "speedup_interleave_vs_2x_single", "backend"]
    cfg = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "CFG")
    assert {k.arg: eval(ast.unparse(k.value), {}) for k in cfg.value.keywords} == {
        k: getattr(pip.CFG, k) for k in ("enc", "dec", "int_steps", "int_res", "svf_res",
                                          "compute_dtype")}
    shape = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "SHAPE")
    assert ast.literal_eval(shape.value) == pip.SHAPE
    assert _port_flags(pip.build_parser()) == {"--device": None, "--out": None}


# ---- svf4: the JAX script's main against the port's probe -----------------------------

SCHEDULE_STEPS, SCHEDULE_EVERY = 450, 200  # the JAX CLI's eval_every with --small


def _synth(n, shape, num_labels):
    """The stand-in synthesis on both sides: the ``n``-th draw's image and
    one-hot labels."""
    rng = np.random.default_rng([77, n])
    lab = rng.integers(num_labels, size=shape)
    return rng.random(shape).astype(np.float32), np.eye(num_labels, dtype=np.uint8)[lab]


def _loss(n, idx):
    return 0.25 + 0.01 * idx + 1e-4 * n


def _maps(n, shape):
    return [np.full(shape, i % 4, np.uint8) for i in range(n)]


def _events():
    return {"configs": [], "maps": [], "synth": [], "draws": [], "evals": []}


def _jax_main(events):
    """The JAX script's ``main`` (and ``_mean_label_dice``) compiled from its
    source, with stand-ins for its ``Trainer``, synthesis, maps and keys."""
    import jax.numpy as jnp

    from multimodal_registration_tpu.evalx.nmi import normalized_mutual_information
    from multimodal_registration_tpu.ops.warp import warp
    from multimodal_registration_tpu.train.config import TrainConfig
    from multimodal_registration_tpu.train.trainer import engine_config_from

    def split(key):
        return tuple((key[0], key[1] + (i,)) for i in (0, 1))

    class Model:
        def apply(self, params, mov, fx):
            events["evals"].append(len(events["draws"]))
            return {"flow_fullres": jnp.zeros(mov.shape[:-1] + (3,)), "moved": mov}

    class JaxTrainer:
        def __init__(self, cfg):
            events["configs"].append(dataclasses.asdict(cfg))
            self.model = Model()

        def init_state(self):
            return "fresh", "adam"

        def put_bank(self, bank):
            return bank

        def put_indices(self, src, trg):
            return src, trg

        def train_step_banked(self, params, opt_state, key, bank, si, ti):
            events["draws"].append((key[0], int(si[0]), int(ti[0])))
            return params, opt_state, {"loss": _loss(len(events["draws"]), int(si[0]))}

    def generate_label_maps(key, n, shape, L, **kw):
        events["maps"].append((key[0], n, tuple(shape), L, kw))
        return _maps(n, shape)

    def labels_to_image(key, lab, cfg):
        # pair s keys its two syntheses from 1000 + s: draws 2 s and 2 s + 1
        n = 2 * (key[0] - 1000) + key[1][0]
        events["synth"].append((key[0] - n // 2, cfg.svf_int_res, int(lab[0, 0, 0]),
                                len(events["draws"])))
        return _synth(n, lab.shape, int(cfg.num_labels))

    ns = {"json": json, "time": time, "np": np, "jnp": jnp,
          "jax": types.SimpleNamespace(
              random=types.SimpleNamespace(PRNGKey=lambda s: (int(s), ()), split=split),
              jit=lambda f: f),
          "normalized_mutual_information": normalized_mutual_information, "warp": warp,
          "labels_to_image": labels_to_image, "generate_label_maps": generate_label_maps,
          "TrainConfig": TrainConfig, "Trainer": JaxTrainer,
          "engine_config_from": engine_config_from}
    path, src = _source("svf4_learn_probe.py")
    nodes = [n for n in ast.parse(src, path).body if isinstance(n, ast.FunctionDef)]
    assert {n.name for n in nodes} == {"_mean_label_dice", "main"}
    exec(compile(ast.Module(nodes, []), path, "exec"), ns)
    return ns["main"]


def _port_stand_ins(events, monkeypatch):
    """The same stand-ins on the port's side."""
    draws_of = {}

    class Model:
        def eval(self):
            return self

        def __call__(self, mov, fx, impl=None):
            events["evals"].append(len(events["draws"]))
            return {"flow_fullres": torch.zeros(mov.shape[:-1] + (3,)), "moved": mov}

    class PortTrainer:
        def __init__(self, cfg, device=None):
            events["configs"].append(dataclasses.asdict(cfg))
            self.model = Model()

        def put_bank(self, bank):
            return torch.as_tensor(bank)

        def put_indices(self, src, trg):
            return torch.as_tensor(src), torch.as_tensor(trg)

        def generator(self, seed):
            return torch.Generator().manual_seed(seed)

        def train_step_banked(self, gen, bank, si, ti):
            events["draws"].append((gen.initial_seed(), int(si[0]), int(ti[0])))
            loss = _loss(len(events["draws"]), int(si[0]))
            return {"loss": torch.tensor(loss, dtype=torch.float64)}

    def generate_label_maps(gen, n, shape, L, device=None, **kw):
        events["maps"].append((gen.initial_seed(), n, tuple(shape), L, kw))
        return _maps(n, shape)

    def labels_to_image(lab, cfg, gen):
        n = draws_of[id(gen)] = draws_of.get(id(gen), -1) + 1
        events["synth"].append((gen.initial_seed(), cfg.svf_int_res, int(lab[0, 0, 0]),
                                len(events["draws"])))
        img, oh = _synth(n, tuple(lab.shape), cfg.num_labels)
        return torch.as_tensor(img), torch.as_tensor(oh)

    monkeypatch.setattr(s4, "Trainer", PortTrainer)
    monkeypatch.setattr(lc, "generate_label_maps", generate_label_maps)
    monkeypatch.setattr(lc, "labels_to_image", labels_to_image)


def _normal(lines):
    return [re.sub(r'"sec_per_step": [0-9.e-]+', '"sec_per_step": _', ln) for ln in lines]


def test_schedule_seeding_and_shared_pairs_equal_the_jax_script(monkeypatch, capsys):
    jax_ev = _events()
    main = _jax_main(jax_ev)
    capsys.readouterr()
    main(SCHEDULE_STEPS, small=True, eval_every=SCHEDULE_EVERY)
    jax_lines = capsys.readouterr().out.splitlines()

    port_ev = _events()
    port_lines = []
    with monkeypatch.context() as m:
        _port_stand_ins(port_ev, m)
        record, state = s4.probe(SCHEDULE_STEPS, True, "cpu", emit=port_lines.append)
    assert port_ev == jax_ev
    assert _normal(port_lines) == _normal(jax_lines)
    # what the events say, spelled out
    assert [c["svf_int_res"] for c in port_ev["configs"]] == [2, 4]
    assert port_ev["maps"] == [(0, 16, (32, 32, 32), 4,
                                {"im_scales": [8, 16], "def_scales": [8]})]
    assert [s[1:] for s in port_ev["synth"]] == [(2, s // 2, 0) for s in range(6)]
    assert {s[0] for s in port_ev["synth"]} == {1000}
    per_arm = SCHEDULE_STEPS
    assert port_ev["draws"][:per_arm] == [(1, i, i) for _, i, _ in port_ev["draws"][per_arm:]]
    assert {d[0] for d in port_ev["draws"]} == {1}
    want_evals = [s + k * per_arm for k in range(2) for s in (200, 400, 450) for _ in range(3)]
    assert port_ev["evals"] == want_evals
    assert [p["step"] for p in record["arms"]["4"]] == [200, 400, 450]


def test_svf4_runs_both_arms_at_16_cubed_on_the_cpu():
    lines = []
    record, state = s4.probe(2, True, "cpu", emit=lines.append, over=TINY)
    assert list(record) == ["workload", "steps", "identity", "arms"]
    assert record["workload"] == "(16, 16, 16) / 4 labels" and record["steps"] == 2
    assert list(record["arms"]) == ["2", "4"]
    for r, traj in record["arms"].items():
        assert [list(p) for p in traj] == [["step", "loss", "nmi", "dice", "sec_per_step"]]
        assert traj[0]["step"] == 2 and np.isfinite(traj[0]["loss"])
    assert [json.loads(ln) for ln in lines] == [
        {"identity": record["identity"]},
        *({"arm": int(r), **p} for r, traj in record["arms"].items() for p in traj), record]
    a, b = (dataclasses.asdict(state["configs"][r]) for r in s4.ARMS)
    assert {k for k in a if a[k] != b[k]} == {"svf_int_res"}
    assert a["enc"] == [4] * 4 and a["in_shape"] == [16, 16, 16]
    assert state["trainers"][2] is not state["trainers"][4]


# ---- conv: the port's call against flax's nn.Conv ---------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_flax_same_padding(stride):
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    cin, cout = 3, 5
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 8, 8, 7, cin)).astype(np.float32)  # even and odd sizes
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        layer = nn.Conv(cout, kernel_size=(3, 3, 3), strides=(stride,) * 3, padding="SAME",
                        dtype=dtype)
        params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
        bias = rng.normal(size=(cout,)).astype(np.float32)
        params = {"params": {"kernel": params["params"]["kernel"], "bias": jnp.asarray(bias)}}
        want = np.asarray(layer.apply(params, jnp.asarray(x)), np.float32)
        w = torch.from_numpy(np.asarray(params["params"]["kernel"]).transpose(4, 3, 0, 1, 2))
        got = cp.conv(torch.from_numpy(x).to(tdtype), w.to(tdtype),
                      torch.from_numpy(bias).to(tdtype), stride).float().numpy()
        assert got.shape == want.shape
        tol = 1e-5 if tdtype == torch.float32 else bf16_ulp(float(np.abs(want).max()))
        assert np.abs(got - want).max() <= tol, (dtype, np.abs(got - want).max(), tol)


def test_conv_probe_rows_on_the_cpu():
    lines = []
    rows = cp.run("cpu", emit=lines.append, cases=[("tiny", (8, 8, 8), 2, 4, 2)])
    assert [json.loads(ln) for ln in lines] == [{k: r[k] for k in ("case", "ms", "tflops")}
                                                for r in rows]
    assert rows[0]["seconds"] > 0 and rows[0]["flops"] == 4 ** 3 * 27 * 2 * 4 * 2


# ---- pair interleave: the guard and the arms on the CPU ----------------------------------

@pytest.fixture(scope="module")
def tiny_pairs():
    """The tiny model with its flow head scaled up: fields of about half a
    voxel, not the initial head's 1e-5."""
    model, vols, rng = pip.build((16, 16, 16), "cpu", TINY_VXM)
    with torch.no_grad():
        model.flow.weight.mul_(3e4)
    return model, vols, rng


def test_staged_tail_equals_the_model_and_arms_equal_single_pairs(tiny_pairs):
    model, vols, rng = tiny_pairs
    diff = pip.guard(model, np.random.default_rng(5), "cpu", (16, 16, 16))
    assert diff == {"moved": 0.0, "warp": 0.0}
    fns = pip.arms(model, vols, "cpu")
    assert tuple(fns) == pip.ARMS
    with torch.inference_mode():
        single_b = pip.arms(model, (vols[2], vols[3], vols[0], vols[1]), "cpu")[
            "single_pair_ms"]()
        want = fns["single_pair_ms"]() + single_b
        assert float(want[0][1].abs().max()) > 0.3
        for name in pip.ARMS[1:]:
            got = fns[name]()
            assert len(got) == 2
            for (gm, gw), (wm, ww) in zip(got, want):
                tol = 1e-6 if name == "batch2_ms_per_pair" else 0.0
                assert gm.shape == wm.shape and gw.shape == ww.shape
                assert float((gm - wm).abs().max()) <= tol, name
                assert float((gw - ww).abs().max()) <= tol, name


def test_pair_probe_lines_and_record_on_the_cpu(monkeypatch):
    monkeypatch.setattr(pip, "ITERS", 1)
    monkeypatch.setattr(pip, "BLOCKS", 1)
    monkeypatch.setattr(pip, "WARMUP", 1)
    lines = []
    res = pip.run((16, 16, 16), "cpu", emit=lines.append, cfg=TINY_VXM,
                  guard_shape=(16, 16, 16))
    assert list(res) == [*pip.ARMS, "speedup_interleave_vs_2x_single", "backend"]
    assert res["backend"] == "cpu" and all(res[k] > 0 for k in pip.ARMS)
    assert [json.loads(ln) for ln in lines] == [
        {"staged_tail_matches_model": True}, *({k: res[k]} for k in pip.ARMS[:4]), res]


@pytest.mark.parametrize("mod, argv", [(s4, ["--small"]), (cp, []), (pip, [])],
                         ids=["svf4_learn_probe", "conv_probe", "pair_interleave_probe"])
def test_the_probes_run_on_the_gpu_unless_asked_for_the_cpu(mod, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
