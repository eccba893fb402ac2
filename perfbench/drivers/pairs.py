"""Registration pairs, back to back, in a closed loop with one caller.

The pairs are float32 tensors resident on the card, registered through
``Registrar.predict_tensors``. Traffic parameters (``traffic/<mix>.json``):
``pairs`` distinct pairs, cycled; ``shape``; ``max_batch`` of the registrar; ``maps`` label maps behind the
pairs; ``shift_std`` / ``shift_scale`` of the moving image's displacement
(voxels, and the noise's relative resolution); ``noise_std``; ``warm_calls``;
``check_sample`` calls kept for the check, drawn from the seed over the
window; ``trace_seconds``.

Weights: the configuration's widths, drawn from the seed
(``reference/model.py::make_weights``), the flow head with the
configuration's ``serving_flow_head_std``.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from perfbench import flops
from perfbench.reference import inputs
from perfbench.reference import model as ref_model
from perfbench.reference import ops


def model_of(config: dict) -> dict:
    """The network's keys as the reference and the registrar read them."""
    m = config["model"]
    return {"enc": list(m["enc"]), "dec": list(m["dec"]), "int_steps": int(m["int_steps"]),
            "int_res": int(m["int_res"]), "svf_res": int(m["svf_res"]),
            "compute_dtype": config.get("compute_dtype", "bfloat16"),
            "payload": config.get("integrate_payload_dtype", "")}


def pair_gaps(moved, warp, ref_moved, ref_warp) -> dict:
    """The numbers compared for one call's outputs against the reference's."""
    d = (warp.float() - ref_warp).abs().max()
    return {"warp_max_rel": float(d / ref_warp.abs().max()),
            "moved_max_abs": float((moved.float() - ref_moved).abs().max())}


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.model = model_of(ctx.config)
        self.shape = tuple(self.t["shape"])
        self.sample = []

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from multimodal_registration_torch import kernels
        from multimodal_registration_torch.infer.config import InferenceConfig
        from multimodal_registration_torch.infer.register import Registrar

        ctx, t, dev = self.ctx, self.t, self.ctx.device
        if dev.type == "cuda":
            kernels.build()
        m = ctx.config["model"]
        self.weights = ref_model.make_weights(ctx.seed, self.model,
                                              ctx.config["serving_flow_head_std"], dev)
        bank = inputs.label_bank(ctx.seed, t["maps"], self.shape, m["num_labels"],
                                 m["im_scales"], m["def_scales"], dev)
        self.mov, self.fix = inputs.pairs(ctx.seed, bank, t["pairs"], m["num_labels"],
                                          t["shift_std"], t["shift_scale"], t["noise_std"])
        del bank
        icfg = InferenceConfig(enc=self.model["enc"], dec=self.model["dec"],
                               int_steps=self.model["int_steps"], int_res=self.model["int_res"],
                               svf_res=self.model["svf_res"],
                               compute_dtype=self.model["compute_dtype"],
                               quantize=ctx.config.get("quantize", ""))
        self.reg = Registrar(icfg, self.weights, max_batch=t["max_batch"], device=dev)
        for i in range(t["warm_calls"]):
            self._call(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _call(self, i: int):
        p = i % self.t["pairs"]
        return self.reg.predict_tensors(self.mov[p: p + 1], self.fix[p: p + 1])

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        dev = self.ctx.device
        cuda = dev.type == "cuda"
        host_lat = None if cuda else []  # the CPU rehearsal's clock
        rng = random.Random(self.ctx.seed)
        k = self.t["check_sample"]
        self.sample = []
        starts, ends = [], []
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            if cuda:
                starts.append(torch.cuda.Event(enable_timing=True))
                ends.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()
            c0 = time.perf_counter()
            out = self._call(n)
            if cuda:
                ends[-1].record()
            else:
                host_lat.append(1e3 * (time.perf_counter() - c0))
            # reservoir sampling: every call equally likely to be checked
            if n < k:
                self.sample.append((n, out))
            else:
                j = rng.randrange(n + 1)
                if j < k:
                    self.sample[j] = (n, out)
            n += 1
        if cuda:
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        lat = [s.elapsed_time(e) for s, e in zip(starts, ends)] if cuda else host_lat
        return {"units": n, "attempted": n, "seconds": elapsed, "pairs_per_s": n / elapsed,
                "pair_ms_p95": (statistics.quantiles(lat, n=20)[-1] if len(lat) > 1
                                else lat[0])}

    # -- tracing --------------------------------------------------------------
    def install_spans(self, spans) -> None:
        from multimodal_registration_torch.models import vxm_dense as vxm_mod

        spans.wrap(self, "_call", "call")
        spans.hook(self.reg.model.unet, "unet")
        spans.wrap(self.reg.model, "flow_head", "flow_head")
        spans.wrap(vxm_mod, "integrate_svf_batch", "integrate")

    def trace_info(self) -> dict:
        m = self.model
        return {"unit_flops": flops.forward_flops(self.shape, m["enc"], m["dec"], m["svf_res"],
                                                  m["int_steps"]),
                "integrate_bytes": flops.integrate_bytes(self.shape, m["int_res"],
                                                         m["int_steps"])}

    # -- the check --------------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.reg = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        ops.no_tf32()
        dev = self.ctx.device
        worst = {}
        refs = {}
        with torch.no_grad():
            for n, (moved, warp) in sorted(self.sample, key=lambda s: s[0] % self.t["pairs"]):
                p = n % self.t["pairs"]
                if p not in refs:
                    refs.clear()
                    refs[p] = ref_model.forward(self.weights, self.mov[p: p + 1],
                                                self.fix[p: p + 1], self.model)
                moved = torch.as_tensor(moved, device=dev)
                warp = torch.as_tensor(warp, device=dev)
                for name, v in pair_gaps(moved, warp, *refs[p]).items():
                    if name not in worst or not v <= worst[name]:  # NaN stays
                        worst[name] = v
        return worst


def control_config(config: dict) -> dict:
    """The control: the program's own int8 path (kernel K8, scales calibrated
    on the first pair it registers), the nearest precision below bf16."""
    return {**config, "quantize": "int8"}

