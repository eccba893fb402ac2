"""The port's trajectory workloads on the CPU: ``tools/learn_ref_workload.py``
and ``tools/learn_model1_workload.py`` against the JAX scripts
``benchmarks/learn_ref_workload.py`` and ``learn_model1_workload.py``.

  * flags, defaults and record keys equal the JAX scripts', read from their
    syntax trees (importing them would import JAX and start its cache); the
    port adds ``--device`` and ``--out-dir``;
  * at 16^3, 4 labels, 2 maps, enc/dec [4] (function arguments, not flags),
    warm from a random checkpoint: leg 1 of 3 steps equals 3 direct calls of
    ``Trainer.train_step_banked`` on the same seeds (the maps' generator 0,
    ``default_rng(0)`` for the indices, the trainer's generator 1): the last
    loss as recorded (rounded to 4 places, as the record rounds) and every
    weight of the checkpoint, exactly; leg 2 of 2 steps resumes to steps
    [0, 3, 5] and draws from ``default_rng(3)`` and generator 4, fresh draws
    (its weights equal 2 direct steps from leg 1's checkpoint on those
    seeds, exactly, and differ from 2 steps on leg 1's seeds);
  * a checkpoint that does not load raises and leaves the record as it was;
    a failure between the checkpoint's and the record's writes leaves the
    record one snapshot behind the checkpoint; nothing is written outside
    ``--out-dir`` (nor under ``benchmarks/``, which ``--out-dir`` refuses);
  * ``learn_model1_workload`` records the identity and each point in both
    regimes, ``smooth`` and ``affine``;
  * the workloads' own logic against the JAX scripts' ``main``, compiled from
    their source and run with stand-ins for what needs JAX training (the
    ``Trainer``, the synthesis, the label maps and the PRNG keys; the JAX
    package's NMI and warp are real). Both sides get the same held-out images
    (a stand-in synthesis that draws from numpy on the pair's seed), a model
    of zero flow, and a training step that only records its draw. Over a
    leg of 2500 steps and a resumed one of 1001, with the snapshot every 1000
    steps and at the last: the map index and the key's (generator's) seed
    of every step, the record's length when each checkpoint is written,
    the records (the identity, the affine regime built by ``rigid_displace``
    with seeds 100 + s, every point but ``sec_per_step``) and the printed
    lines (but the seconds a step) are equal, exactly.
"""

import ast
import dataclasses
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_to_jax
from multimodal_registration_torch.synth.labelmaps import generate_label_maps
from multimodal_registration_torch.tools import learn_model1_workload as lm1
from multimodal_registration_torch.tools import learn_ref_workload as lrw
from multimodal_registration_torch.train.trainer import Trainer, init_like_flax_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks")
TINY = dict(in_shape=[16, 16, 16], num_labels=4, num_maps=2, enc=[4] * 4, dec=[4] * 6)
TOOLS = {"ref": (lrw, lrw.ref_spec(0)), "model1": (lm1, lm1.SPEC)}


def _tree(name):
    path = os.path.join(BENCH, name)
    return ast.parse(open(path).read(), path)


def _dict_key_sets(tree):
    """The key sets of the script's dict literals with constant keys."""
    return {frozenset(k.value for k in n.keys) for n in ast.walk(tree)
            if isinstance(n, ast.Dict) and n.keys
            and all(isinstance(k, ast.Constant) for k in n.keys)}


def _quiet(*_):
    pass


def _run(tool, steps, warm, out, **kw):
    mod, _ = TOOLS[tool]
    if tool == "ref":
        return lrw.run(steps, warm, 0, str(out), "cpu", TINY, emit=_quiet, **kw)
    return lm1.run(steps, warm, str(out), "cpu", TINY, emit=_quiet, **kw)


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A random enc/dec [4] checkpoint (nonzero flows) in the JAX flat keys."""
    model = VxmDense(VxmConfig(enc=(4,) * 4, dec=(4,) * 6), device="cpu")
    init_like_flax_(model, 3)
    with torch.no_grad():
        model.flow.weight.mul_(200.0)
    path = str(tmp_path_factory.mktemp("warm") / "w.npz")
    np.savez(path, **params_to_jax(model.state_dict()))
    return path


def _direct(tool, ckpt, steps, seed):
    """``steps`` direct ``train_step_banked`` calls from ``ckpt``, the draws
    seeded as a leg with ``step_base`` = ``seed``: ``(last loss, weights)``."""
    _, spec = TOOLS[tool]
    cfg = lrw.workload_config(spec, TINY)
    tr = Trainer(cfg, device="cpu")
    tr.load_checkpoint(ckpt)
    maps = generate_label_maps(torch.Generator().manual_seed(0), cfg.num_maps,
                               tuple(cfg.in_shape), cfg.num_labels, device="cpu",
                               im_scales=cfg.im_scales, def_scales=cfg.def_scales)
    bank = tr.put_bank(np.stack(maps).astype(np.uint8))
    rng, gen = np.random.default_rng(seed), tr.generator(1 + seed)
    for _ in range(steps):
        idx = rng.integers(len(maps), size=1)
        si, ti = tr.put_indices(idx, idx)
        aux = tr.train_step_banked(gen, bank, si, ti)
    return float(aux["loss"]), params_to_jax(tr.model.state_dict())


def _weights(path):
    with np.load(path) as z:
        return dict(z)


def _same_weights(a, b):
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


# ---- flags, defaults and keys against the JAX scripts -------------------------------

def test_learn_ref_flags_equal_the_jax_scripts():
    tree = _tree("learn_ref_workload.py")
    want = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in n.keywords}
            want[n.args[0].value] = ast.literal_eval(kw["default"]) if "default" in kw else None
    got = {a.option_strings[0] if a.option_strings else a.dest: a.default
           for a in lrw.build_parser()._actions if a.dest != "help"}
    assert want == {"steps": 6000, "warm": None, "--width": 0}
    assert got == {**want, "--device": None, "--out-dir": None}
    args = lrw.build_parser().parse_args(["12", "w.npz", "--width", "256"])
    assert (args.steps, args.warm, args.width) == (12, "w.npz", 256)
    assert lrw.SHAPE == (160, 160, 192) and lrw.NUM_LABELS == 26 and lrw.EVAL_EVERY == 1000
    # the JAX script's training configuration (its TrainConfig dict)
    d = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "dict"
             and any(k.arg == "num_maps" for k in n.keywords))
    jax_cfg = {k.arg: ast.literal_eval(k.value) for k in d.keywords
               if isinstance(k.value, ast.Constant)}
    cfg = lrw.workload_config(lrw.ref_spec(0))
    assert {k: getattr(cfg, k) for k in jax_cfg} == jax_cfg
    assert lrw.workload_config(lrw.ref_spec(256)).enc == [256] * 4


def test_learn_model1_flags_equal_the_jax_scripts():
    tree = _tree("learn_model1_workload.py")
    default = next(n.orelse.value for n in ast.walk(tree)
                   if isinstance(n, ast.IfExp) and isinstance(n.orelse, ast.Constant)
                   and isinstance(n.orelse.value, int))
    got = {a.option_strings[0] if a.option_strings else a.dest: a.default
           for a in lm1.build_parser()._actions if a.dest != "help"}
    assert got == {"steps": default, "warm": None, "--device": None, "--out-dir": None}
    assert default == 12000
    cfg = lrw.workload_config(lm1.SPEC)
    assert cfg.vel_res == [32, 64] and cfg.num_maps == 40 and cfg.same_subj


@pytest.mark.parametrize("tool, script", [("ref", "learn_ref_workload.py"),
                                          ("model1", "learn_model1_workload.py")])
def test_record_keys_equal_the_jax_scripts(tool, script, warm, tmp_path):
    keys = _dict_key_sets(_tree(script))
    log = _run(tool, 1, warm, tmp_path)
    assert frozenset(log) in keys
    assert frozenset(log["identity"]) in keys
    for point in log["trajectory"]:
        assert frozenset(point) in keys
        for v in point.values():
            if isinstance(v, dict):
                assert frozenset(v) in keys
    if tool == "model1":
        assert set(log["identity"]) == set(log["trajectory"][0]) - {"step", "loss",
                                                                     "sec_per_step"}
        assert all(frozenset(v) in keys for v in log["identity"].values())
    assert log["trajectory"][0]["loss"] is None
    assert json.load(open(os.path.join(tmp_path, TOOLS[tool][1].results))) == log


# ---- legs, resume and the crash-safe order --------------------------------------------

@pytest.mark.parametrize("tool", ["ref", "model1"])
def test_first_leg_equals_direct_steps_and_the_second_resumes(tool, warm, tmp_path):
    _, spec = TOOLS[tool]
    ckpt = str(tmp_path / spec.ckpt)
    log1 = _run(tool, 3, warm, tmp_path)
    assert [p["step"] for p in log1["trajectory"]] == [0, 3]
    loss, weights = _direct(tool, warm, 3, 0)
    assert log1["trajectory"][-1]["loss"] == round(loss, 4)
    assert _same_weights(_weights(ckpt), weights)
    leg1 = _weights(ckpt)
    log2 = _run(tool, 2, ckpt, tmp_path)
    assert [p["step"] for p in log2["trajectory"]] == [0, 3, 5]
    assert log2["trajectory"][:2] == log1["trajectory"] and log2["warm_start"] == ckpt
    # leg 2 draws from default_rng(3) and generator 4: fresh pairs
    np.savez(str(tmp_path / "leg1.npz"), **leg1)
    loss2, weights2 = _direct(tool, str(tmp_path / "leg1.npz"), 2, 3)
    assert log2["trajectory"][-1]["loss"] == round(loss2, 4)
    assert _same_weights(_weights(ckpt), weights2)
    _, replayed = _direct(tool, str(tmp_path / "leg1.npz"), 2, 0)
    assert not _same_weights(weights2, replayed)


def test_a_checkpoint_that_does_not_load_refuses_to_resume(warm, tmp_path):
    spec = lrw.ref_spec(0)
    _run("ref", 1, warm, tmp_path)
    record = open(tmp_path / spec.results).read()
    ckpt = tmp_path / spec.ckpt
    ckpt.write_bytes(b"not an npz")
    with pytest.raises(Exception):
        _run("ref", 2, str(ckpt), tmp_path)
    assert open(tmp_path / spec.results).read() == record
    with pytest.raises(FileNotFoundError):
        _run("ref", 2, str(tmp_path / "missing.npz"), tmp_path)


def test_a_failure_between_the_writes_leaves_the_record_one_snapshot_behind(
        warm, tmp_path, monkeypatch):
    spec = lrw.ref_spec(0)
    real, calls = lrw.write_record, []

    def failing(path, log):
        calls.append(len(log["trajectory"]))
        if len(calls) == 2:
            raise OSError("disk full")
        real(path, log)

    monkeypatch.setattr(lrw, "write_record", failing)
    with pytest.raises(OSError):
        _run("ref", 3, warm, tmp_path)
    monkeypatch.setattr(lrw, "write_record", real)
    record = json.load(open(tmp_path / spec.results))
    assert [p["step"] for p in record["trajectory"]] == [0]
    _, weights = _direct("ref", warm, 3, 0)
    assert _same_weights(_weights(tmp_path / spec.ckpt), weights)  # the checkpoint is ahead
    # the resume retrains the lost leg from the record's last step
    log = _run("ref", 3, str(tmp_path / spec.ckpt), tmp_path)
    assert [p["step"] for p in log["trajectory"]] == [0, 3]


@pytest.mark.parametrize("tool", ["ref", "model1"])
def test_nothing_is_written_outside_the_out_dir(tool, warm, tmp_path, monkeypatch):
    _, spec = TOOLS[tool]
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = {p: os.path.getmtime(os.path.join(BENCH, p)) for p in os.listdir(BENCH)}
    out = tmp_path / "out"
    _run(tool, 2, warm, out)
    _run(tool, 1, str(out / spec.ckpt), out)
    assert sorted(os.listdir(out)) == sorted([spec.results, spec.ckpt])
    assert os.listdir(cwd) == []
    assert {p: os.path.getmtime(os.path.join(BENCH, p)) for p in os.listdir(BENCH)} == before
    with pytest.raises(ValueError, match="never write under"):
        _run(tool, 1, warm, os.path.join(BENCH, "x"))


def test_the_default_warm_start_follows_the_jax_script(tmp_path):
    spec = lrw.ref_spec(0)
    assert lrw.default_warm(spec, str(tmp_path)) == lrw.WARM_24K
    assert lrw.default_warm(lrw.ref_spec(256), str(tmp_path), 256) is None
    assert lm1.default_warm(str(tmp_path)) == lm1.WARM_REF
    for s, fn in ((spec, lambda: lrw.default_warm(spec, str(tmp_path))),
                  (lm1.SPEC, lambda: lm1.default_warm(str(tmp_path)))):
        (tmp_path / s.ckpt).write_bytes(b"")
        assert fn() == str(tmp_path / s.ckpt)
    assert os.path.dirname(lrw.paths(spec, None)[0]) == lrw.OUT_DIR


@pytest.mark.parametrize("mod", [lrw, lm1])
def test_the_workloads_run_on_the_gpu_unless_asked_for_the_cpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["1"])


# ---- the JAX scripts' own main: schedule, seeding, resume and regimes -----------------

SIZE = dict(num_maps=2, enc=[4] * 4, dec=[4] * 6)
SCRIPTS = {"ref": ("learn_ref_workload.py", {"main", "_set_width_paths", "mean_label_dice"}),
           "model1": ("learn_model1_workload.py", {"main", "rigid_displace"})}


def _synth(seed, n, shape, num_labels):
    """The stand-in synthesis on both sides: the ``n``-th image and one-hot
    labels drawn from the pair's ``seed``."""
    rng = np.random.default_rng([seed, n])
    lab = rng.integers(num_labels, size=shape)
    return rng.random(shape).astype(np.float32), np.eye(num_labels, dtype=np.float32)[lab]


def _loss(n, idx):
    return 0.25 + 0.01 * idx + 1e-4 * n


def _points(path):
    """The trajectory's length in the record at ``path`` (None: no record)."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return len(json.load(f)["trajectory"])


def _jax_main(tool, out, events):
    """The JAX script's ``main`` compiled from its source, writing into
    ``out``, with stand-ins for its ``Trainer``, synthesis, maps and keys."""
    import jax.numpy as jnp

    from multimodal_registration_tpu.evalx.nmi import normalized_mutual_information
    from multimodal_registration_tpu.train.config import TrainConfig as JaxTrainConfig

    script, defs = SCRIPTS[tool]
    spec = TOOLS[tool][1]
    shape, L = tuple(TINY["in_shape"]), TINY["num_labels"]

    def split(key):
        return tuple((key[0], key[1] + (i,)) for i in (0, 1))

    @dataclasses.dataclass
    class Engine:
        svf_int_res: int = 4

    class JaxTrainer:
        def __init__(self, cfg):
            self.engine_cfg = Engine()
            self.optimizer = types.SimpleNamespace(init=lambda params: "adam")
            self._repl = None
            self.model = types.SimpleNamespace(apply=lambda params, mov, fx: {
                "flow_fullres": jnp.zeros(mov.shape[:-1] + (3,)), "moved": mov})

        def init_state(self):
            return "fresh", "adam"

        def load_checkpoint(self, path):
            np.load(path).close()
            return "loaded", None, None

        def put_bank(self, bank):
            return bank

        def put_indices(self, src, trg):
            return src, trg

        def train_step_banked(self, params, opt_state, key, bank, si, ti):
            events["draws"].append((key[0], int(si[0])))
            return params, opt_state, {"loss": _loss(len(events["draws"]), int(si[0]))}

        def save_checkpoint(self, stem, params, epoch):
            events["ckpt"].append(_points(ns["RESULTS"]))
            np.savez(stem + ".npz", w=np.zeros(1))

    def labels_to_image(key, lab, cfg):
        events["eval_svf_int_res"].add(cfg.svf_int_res)
        img, oh = _synth(key[0], key[1][0], shape, L)
        return img, oh

    ns = {"json": json, "os": os, "time": __import__("time"), "np": np, "jnp": jnp,
          "jax": types.SimpleNamespace(
              random=types.SimpleNamespace(PRNGKey=lambda s: (int(s), ()), split=split),
              jit=lambda f: f, device_put=lambda x, *_: x),
          "normalized_mutual_information": normalized_mutual_information,
          "labels_to_image": labels_to_image,
          "generate_label_maps": lambda key, n, shape, L, **kw: [np.zeros(shape, np.uint8)] * n,
          "TrainConfig": types.SimpleNamespace(
              from_dict=lambda d: JaxTrainConfig.from_dict({**d, **SIZE})),
          "Trainer": JaxTrainer, "SHAPE": shape, "NUM_LABELS": L, "HERE": str(out),
          "RESULTS": str(out / spec.results), "CKPT": str(out / spec.ckpt)}
    if tool == "model1":
        _compiled_into("learn_ref_workload.py", {"mean_label_dice"}, ns)
    _compiled_into(script, defs, ns)
    return ns


def _compiled_into(script, defs, ns):
    path = os.path.join(BENCH, script)
    tree = ast.parse(open(path).read(), path)
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in defs]
    assert {n.name for n in nodes} == defs
    exec(compile(ast.Module(nodes, []), path, "exec"), ns)


def _port_stand_ins(tool, out, events, monkeypatch):
    """The same stand-ins on the port's side: its synthesis of the held-out
    pairs and its training step; the checkpoint's write is recorded."""
    spec = TOOLS[tool][1]
    L = TINY["num_labels"]
    draws_of = {}

    def labels_to_image(lab, cfg, gen):
        events["eval_svf_int_res"].add(cfg.svf_int_res)
        n = draws_of[id(gen)] = draws_of.get(id(gen), -1) + 1
        img, oh = _synth(gen.initial_seed(), n, tuple(lab.shape), L)
        return torch.as_tensor(img), torch.as_tensor(oh)

    def train_step_banked(self, gen, bank, si, ti):
        events["draws"].append((gen.initial_seed(), int(si[0])))
        return {"loss": torch.tensor(_loss(len(events["draws"]), int(si[0])))}

    real_save = lrw.save_weights

    def save_weights(trainer, tmp, ckpt):
        events["ckpt"].append(_points(str(out / spec.results)))
        real_save(trainer, tmp, ckpt)

    monkeypatch.setattr(lrw, "labels_to_image", labels_to_image)
    monkeypatch.setattr(Trainer, "train_step_banked", train_step_banked)
    monkeypatch.setattr(lrw, "save_weights", save_weights)


def _normal(log, lines, dirs):
    """The record without ``sec_per_step`` and the lines without the seconds
    a step, the output directory's path cut away."""
    log = json.loads(json.dumps(log))
    log["warm_start"] = os.path.basename(log["warm_start"])
    for p in log["trajectory"]:
        del p["sec_per_step"]
    text = "\n".join(lines)
    for d in dirs:
        text = text.replace(str(d) + os.sep, "")
    text = re.sub(r"\([0-9.]+s/step\)", "(s/step)", text)
    return log, re.sub(r'"sec_per_step": [0-9.e-]+', '"sec_per_step": _', text)


@pytest.fixture(scope="module")
def zero_warm(tmp_path_factory):
    """A checkpoint of zeros at enc/dec [4]: the port's model then gives zero
    flow, as the JAX side's stand-in model does."""
    model = VxmDense(VxmConfig(enc=(4,) * 4, dec=(4,) * 6), device="cpu")
    path = str(tmp_path_factory.mktemp("zero") / "zero.npz")
    np.savez(path, **{k: np.zeros_like(v) for k, v in params_to_jax(model.state_dict()).items()})
    return path


@pytest.mark.parametrize("tool", ["ref", "model1"])
def test_schedule_seeding_resume_and_regimes_equal_the_jax_scripts(
        tool, zero_warm, tmp_path, monkeypatch, capsys):
    spec = TOOLS[tool][1]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_out.mkdir()
    port_out.mkdir()
    legs = []
    for steps, own in ((2500, False), (1001, True)):
        jax_ev = {"draws": [], "ckpt": [], "eval_svf_int_res": set()}
        ns = _jax_main(tool, jax_out, jax_ev)
        capsys.readouterr()
        if tool == "ref":
            ns["main"](steps, ns["CKPT"] if own else zero_warm, 0)
        else:
            ns["main"](steps, ns["CKPT"] if own else zero_warm)
        jax_lines = capsys.readouterr().out.splitlines()
        with open(ns["RESULTS"]) as f:
            jax_log = json.load(f)

        port_ev = {"draws": [], "ckpt": [], "eval_svf_int_res": set()}
        with monkeypatch.context() as m:
            _port_stand_ins(tool, port_out, port_ev, m)
            port_lines = []
            warm = str(port_out / spec.ckpt) if own else zero_warm
            cfg = dict(TINY, num_maps=SIZE["num_maps"])
            if tool == "ref":
                port_log = lrw.run(steps, warm, 0, str(port_out), "cpu", cfg,
                                   emit=port_lines.append)
            else:
                port_log = lm1.run(steps, warm, str(port_out), "cpu", cfg,
                                   emit=port_lines.append)
        assert port_ev == jax_ev
        dirs = (jax_out, port_out)
        assert _normal(port_log, port_lines, dirs) == _normal(jax_log, jax_lines, dirs)
        legs.append((port_ev, port_log))
    (ev1, log1), (ev2, log2) = legs
    assert [p["step"] for p in log2["trajectory"]] == [0, 1000, 2000, 2500, 3500, 3501]
    assert ev1["ckpt"] == [None, 1, 2, 3] and ev2["ckpt"] == [4, 5]  # before the record
    assert {s for s, _ in ev1["draws"]} == {1} and {s for s, _ in ev2["draws"]} == {2501}
    assert [i for _, i in ev2["draws"]] != [i for _, i in ev1["draws"][:1001]]  # fresh draws
    assert ev1["eval_svf_int_res"] == {lrw.EVAL_SVF_INT_RES}
    if tool == "model1":
        assert log1["identity"]["affine"] != log1["identity"]["smooth"]
