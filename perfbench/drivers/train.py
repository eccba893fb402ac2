"""SynthMorph training steps, back to back, through
``Trainer.train_step_banked`` on a bank of label maps resident on the card.

Traffic parameters (``traffic/<mix>.json``): ``maps`` label maps in the bank;
``first_steps`` steps of the set-up, which warm every shape up and whose
readings the check compares (the first gradient as Adam's state holds it
after one step, the parameters after the last); ``sequence`` source
and target indices drawn from the seed (the sources in random permutations
of the bank, so that the first steps' rows all differ; each target another
map than its source); ``trace_seconds``.

The check also follows one step of the window: the first to start after a
share of the window drawn from the seed. Its state (the parameters, Adam's
moments and step, the generator) is copied just before it and the result
just after, so that the reference takes the same step from the same state.

Weights: the configuration's widths drawn from the seed
(``reference/model.py::make_weights``), the flow head with
``train_flow_head_std`` (VoxelMorph's 1e-5). The configuration's ``model``
is ``config/config.json``; the trainer runs on one card.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from perfbench import flops
from perfbench.drivers.pairs import model_of
from perfbench.reference import inputs, ops
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train


def indices(seed: int, count: int, maps: int) -> tuple:
    """``(src, trg)`` int64 arrays of ``count`` steps."""
    rng = np.random.default_rng(int(seed))
    src = np.concatenate([rng.permutation(maps) for _ in range(-(-count // maps))])[:count]
    trg = (src + rng.integers(1, maps, size=count)) % maps
    return src.astype(np.int64), trg.astype(np.int64)


def synth_cfg(model: dict) -> dict:
    """The synthesis's keys as the reference reads them (``TrainConfig``'s
    defaults where ``config.json`` states none)."""
    return {"num_labels": model["num_labels"], "vel_std": float(model["vel_std"]),
            "vel_res": float(model["vel_res"]), "bias_std": float(model["bias_std"]),
            "bias_res": float(model["bias_res"]), "blur_std": float(model["blur_std"]),
            "gamma": float(model["gamma"]), "svf_int_res": int(model.get("svf_int_res", 4)),
            "lr": float(model["lr"]), "reg_param": float(model["reg_param"])}


def leaf_gaps(prog: dict, ref: dict, counted) -> list:
    """Each counted leaf's gap between the program's norm and the
    reference's, over the larger of the leaf's reference norm and the median
    leaf's."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return [abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med) for k in counted]


def worst(gaps: list) -> float:
    """The largest gap; NaN if any is."""
    return float("nan") if any(g != g for g in gaps) else max(gaps)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.model = model_of(ctx.config)
        self.cfg = ctx.config["model"]
        self.shape = tuple(self.cfg["in_shape"])
        self.control = ctx.config.get("precision") == "fp8"
        self.trainer = None
        self.mid = None

    def setup(self) -> None:
        from multimodal_registration_torch import kernels
        from multimodal_registration_torch.train.config import TrainConfig
        from multimodal_registration_torch.train.trainer import Trainer

        ctx, t, dev = self.ctx, self.t, self.ctx.device
        if dev.type == "cuda":
            kernels.build()
        self.weights = ref_model.make_weights(ctx.seed, self.model,
                                              ctx.config["train_flow_head_std"], dev)
        self.bank = inputs.label_bank(ctx.seed, t["maps"], self.shape, self.cfg["num_labels"],
                                      self.cfg["im_scales"], self.cfg["def_scales"], dev)
        self.src, self.trg = indices(ctx.seed, t["sequence"], t["maps"])
        self.first = t["first_steps"]
        cfg = TrainConfig.from_dict({**self.cfg, "num_devices": 1,
                                     "compute_dtype": self.model["compute_dtype"]})
        self.trainer = Trainer(cfg, device=dev)
        self.trainer.model.load_state_dict(self.weights)
        self.src_t = torch.as_tensor(self.src, device=dev)
        self.trg_t = torch.as_tensor(self.trg, device=dev)
        self.gen = self.trainer.generator(ctx.seed)
        self.names = {p: k for k, p in self.trainer.model.named_parameters()}
        for i in range(self.first):
            self._call(i)
            if i == 0:
                # Adam's first moment after one step is (1 - b1) g
                self.grads = {k: m / 0.1 for k, m in self._moments("exp_avg").items()}
        self.after = self._params()
        self.next = self.first
        if self.control:
            # the control's readings of the first steps: the reference in fp8
            got = ref_train.steps(self.weights, self.bank, self.src, self.trg,
                                  torch.Generator(device=dev).manual_seed(ctx.seed),
                                  synth_cfg(self.cfg), self.model, self.first, ref_train.fp8_conv)
            self.grads, self.after = got["grads"], got["params"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _params(self) -> dict:
        return {k: v.detach().clone() for k, v in self.trainer.model.state_dict().items()}

    def _moments(self, key: str) -> dict:
        """Copies of one of Adam's per-parameter states by name; zeros for a
        parameter that has none yet (no gradient reached it)."""
        state = self.trainer.optimizer.state
        return {k: (state[p][key].clone() if key in state.get(p, {}) else torch.zeros_like(p))
                for p, k in self.names.items()}

    def _followed_call(self, i: int):
        """Step ``i``, with its state copied before and after for the check."""
        steps = [s["step"] for s in self.trainer.optimizer.state.values() if "step" in s]
        mid = {"i": i, "gen": self.gen.get_state(), "params": self._params(),
               "m": self._moments("exp_avg"), "v": self._moments("exp_avg_sq"),
               "t": steps[0].clone() if steps else 0}
        out = self._call(i)
        mid["m_after"], mid["after"] = self._moments("exp_avg"), self._params()
        self.mid = mid
        return out

    def _call(self, i: int):
        return self.trainer.train_step_banked(self.gen, self.bank, self.src_t[i: i + 1],
                                              self.trg_t[i: i + 1])

    def window(self, seconds: float) -> dict:
        dev = self.ctx.device
        cuda = dev.type == "cuda"
        # the followed step: the first to start after this share of the window
        # (one step past its end, should none start within it)
        share = random.Random(self.ctx.seed).uniform(0.1, 0.9)
        self.mid = None
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = 0
        while self.next < len(self.src):
            now = time.perf_counter() - t0
            if now >= seconds and self.mid is not None:
                break
            if self.mid is None and now >= share * seconds:
                self._followed_call(self.next)
            else:
                self._call(self.next)
            self.next += 1
            n += 1
        if cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        return {"units": n, "attempted": n, "seconds": elapsed, "train_steps_per_s": n / elapsed}

    def install_spans(self, spans) -> None:
        from multimodal_registration_torch.train import trainer as trainer_mod

        spans.wrap(self, "_call", "call")
        spans.wrap(trainer_mod, "draw_batch", "draw_batch")
        spans.wrap(trainer_mod, "build_batch", "build_batch")
        spans.wrap(trainer_mod, "loss_from_batch", "loss")
        spans.wrap(torch.autograd, "backward", "backward")
        spans.wrap(trainer_mod, "clip_by_global_norm_", "optimizer")
        spans.wrap(self.trainer.optimizer, "step", "optimizer")

    def trace_info(self) -> dict:
        m = self.model
        return {"unit_flops": flops.forward_flops(self.shape, m["enc"], m["dec"], m["svf_res"],
                                                  m["int_steps"])}

    def release(self) -> None:
        self.trainer = self.gen = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ops.no_tf32()
        dev = self.ctx.device
        cfg = synth_cfg(self.cfg)
        ref = ref_train.steps(self.weights, self.bank, self.src, self.trg,
                              torch.Generator(device=dev).manual_seed(self.ctx.seed),
                              cfg, self.model, self.first)
        # the losses (at init the field is 1e-5 voxels, so they are the
        # synthesis's) agree to a few float32 ulps and are not compared
        out = gaps(self.weights, self.grads, self.after, ref["grads"], ref["params"])
        mid = self.mid
        i = mid["i"]

        def gen():
            g = torch.Generator(device=dev)
            g.set_state(mid["gen"])
            return g

        state = {"t": int(mid["t"]), "m": mid["m"], "v": mid["v"]}
        ref_mid = ref_train.step_from(mid["params"], state, self.bank, self.src[i], self.trg[i],
                                      gen(), cfg, self.model)
        if self.control:
            got = ref_train.step_from(mid["params"], state, self.bank, self.src[i],
                                      self.trg[i], gen(), cfg, self.model, ref_train.fp8_conv)
            grads, after = got["grads"], got["params"]
        else:
            # Adam's first moment: m' = b1 m + (1 - b1) g
            grads = {k: (mid["m_after"][k] - 0.9 * mid["m"][k]) / 0.1 for k in mid["m"]}
            after = mid["after"]
        won = gaps(mid["params"], grads, after, ref_mid["grads"], ref_mid["params"])
        out.update({f"window_{k}": v for k, v in won.items()})
        return out


def gaps(before: dict, grads: dict, after: dict, ref_grads: dict, ref_after: dict) -> dict:
    """The gradient's and the parameters' change's gaps, by the worst and
    the median counted leaf, of a step or steps taken from ``before``."""
    gnorm = {k: float(g.norm()) for k, g in ref_grads.items()}
    med = float(np.median(list(gnorm.values())))
    # leaves whose reference gradient is nought to rounding move by round-off alone
    counted = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    grad = leaf_gaps(grads, ref_grads, counted)
    change = leaf_gaps({k: after[k] - before[k] for k in before},
                       {k: ref_after[k] - before[k] for k in before}, counted)
    return {"grad_gap": worst(grad), "grad_gap_median": float(np.median(grad)),
            "change_gap": worst(change), "change_gap_median": float(np.median(change))}


def control_config(config: dict) -> dict:
    """The control: the reference put in the program's place with the U-Net's
    convs in float8 (``reference/train.py::fp8_conv``), the nearest precision
    below bf16; the program has no such training path. The program still
    drives the window; the followed step's readings are the control's, taken
    from the program's state before it."""
    return {**config, "precision": "fp8"}


@contextlib.contextmanager
def state_unchanged():
    """A planted fault: every optimizer step returns the state it was given."""
    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


FAULTS = {"state_unchanged": state_unchanged}
