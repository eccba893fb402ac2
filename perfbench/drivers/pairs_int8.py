"""Registration pairs in the configuration's int8 mode, checked against the
plain int8 reference.

The load is ``drivers/pairs.py``'s, through the same
``Registrar.predict_tensors``; the registrar calibrates its activation
scales itself, lazily, on the first pair it registers (pair 0, in the first
warm call of the set-up). The check compares each sampled call's outputs
with ``reference/int8.py``'s forward of its pair, whose scales the reference
calibrates on pair 0 itself, and the registrar's scales with the
reference's (``scale_max_rel``, 0 where no conv is wide enough to quantize).

The control is the program with every calibrated ``amax`` times 16 (the
configuration key ``amax_factor``): 4-bit activations through the same int8
convs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import flops_int8
from perfbench.drivers import pairs
from perfbench.reference import int8 as ref_int8
from perfbench.reference import ops


def block_of(key: str) -> str:
    """The reference's block name (``unet.enc_1``) of a program scale key
    (``unet/enc_1/amax``)."""
    return key.rsplit("/", 1)[0].replace("/", ".")


def scale_gap(program: dict, reference: dict) -> float:
    """The widest relative gap between two ``{block: amax}``; infinite when
    they name different blocks, 0 when both are empty."""
    if set(program) != set(reference):
        return float("inf")
    return max((abs(program[k] - reference[k]) / reference[k] for k in reference), default=0.0)


class Driver(pairs.Driver):
    def setup(self) -> None:
        super().setup()
        scales = dict(self.reg.quant_scales or {})
        factor = np.float32(self.ctx.config.get("amax_factor", 1.0))
        if factor != 1:
            scales = {k: np.float32(v) * factor for k, v in scales.items()}
            self.reg.quant_scales = scales
            self.reg.model.set_quant_scales(scales)
            self._call(0)  # the int8 convs' operands for the new scales, before the window
            if self.ctx.device.type == "cuda":
                torch.cuda.synchronize(self.ctx.device)
        self.amax = {block_of(k): float(v) for k, v in scales.items()}

    def trace_info(self) -> dict:
        m = self.model
        return {**super().trace_info(),
                "int8_ops": flops_int8.int8_ops(self.shape, m["enc"], m["dec"]),
                "quantize_bytes": flops_int8.quantize_bytes(self.shape, m["enc"], m["dec"])}

    def check(self) -> dict:
        ops.no_tf32()
        dev = self.ctx.device
        amax = ref_int8.calibrate(self.weights, [(self.mov[0:1], self.fix[0:1])], self.model)
        worst = {}
        ref = {}
        for n, (moved, warp) in sorted(self.sample, key=lambda s: s[0] % self.t["pairs"]):
            p = n % self.t["pairs"]
            if p not in ref:
                ref.clear()
                ref[p] = ref_int8.forward(self.weights, self.mov[p: p + 1],
                                          self.fix[p: p + 1], self.model, amax)
            gaps = pairs.pair_gaps(torch.as_tensor(moved, device=dev),
                                   torch.as_tensor(warp, device=dev), *ref[p])
            for name, v in gaps.items():
                if name not in worst or not v <= worst[name]:  # NaN stays
                    worst[name] = v
        worst["scale_max_rel"] = scale_gap(self.amax, amax)
        return worst


def control_config(config: dict) -> dict:
    """The control: every calibrated ``amax`` times 16, 4-bit activations."""
    return {**config, "amax_factor": 16.0}


@contextlib.contextmanager
def amax_halved():
    """A planted fault: the registrar's calibration returns every ``amax``
    halved, so that the int8 convs clip their inputs."""
    from multimodal_registration_torch.models import quantize

    real = quantize.calibrate_scales

    def halved(*args, **kwargs):
        return {k: v * np.float32(0.5) for k, v in real(*args, **kwargs).items()}

    quantize.calibrate_scales = halved
    try:
        yield
    finally:
        quantize.calibrate_scales = real


FAULTS = {"amax_halved": amax_halved}
