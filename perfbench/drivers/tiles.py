"""Subjects registered tile by tile, back to back, in a closed loop with one
caller: ``use_subvol`` of ``config/config_inference.json``.

The load is ``drivers/pairs.py``'s pairs, resident on the card; each call
registers one pair through ``Registrar.register_tensors``, which cuts the
configuration's overlapping tiles on the card, runs them through the model
in chunks of ``max_batch`` (the last padded), blends their fields and warps
the whole moving volume. The check compares each sampled call's blended
half-resolution field (``warp_max_rel``) and moved volume
(``moved_max_abs``) with ``reference/tiles.py``'s, the same tiles
registered one at a time by the plain reference.

The tiling is the configuration's ``use_subvol``, ``subvol_size`` and
``min_perc_overlap``. Where a configuration has none of them (the CPU tests
swap in a model without them), the tiles are half the traffic's shape on
each axis, floored to a multiple of 16 and at least 16, with the least
overlap 0.1: the published ratio of 80x80x96 tiles to a 160x160x192 volume.

The control is the program's int8 path, as for the pairs; the fault
``flat_blend`` sets every pyramid weight of the blend to 1.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench import flops_tiles
from perfbench.drivers import pairs
from perfbench.reference import inputs
from perfbench.reference import model as ref_model
from perfbench.reference import ops
from perfbench.reference import tiles as ref_tiles


def tiling_of(config: dict, shape) -> dict:
    """The registrar's tiling keys: the configuration's, or half the shape."""
    m = config["model"]
    return {"use_subvol": bool(m.get("use_subvol", True)),
            "subvol_size": [int(s) for s in m.get(
                "subvol_size", [max(16, int(s) // 32 * 16) for s in shape])],
            "min_perc_overlap": float(m.get("min_perc_overlap", 0.1))}


class Driver(pairs.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.tiling = tiling_of(ctx.config, self.shape)
        self.calls = 0

    def setup(self) -> None:
        from multimodal_registration_torch import kernels
        from multimodal_registration_torch.infer.config import InferenceConfig
        from multimodal_registration_torch.infer.register import Registrar

        if not hasattr(Registrar, "register_tensors"):
            raise SystemExit("this program has no Registrar.register_tensors to run tiles")
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
                               quantize=ctx.config.get("quantize", ""), **self.tiling)
        self.reg = Registrar(icfg, self.weights, max_batch=t["max_batch"], device=dev)
        for i in range(t["warm_calls"]):
            self._call(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _call(self, i: int):
        p = i % self.t["pairs"]
        self.calls += 1
        return self.reg.register_tensors(self.mov[p], self.fix[p])[:2]

    def trace_info(self) -> dict:
        m = self.model
        tile = [s // 16 * 16 for s in self.tiling["subvol_size"]]
        count = flops_tiles.tile_count(self.shape, tile, self.tiling["min_perc_overlap"])
        info = {"unit_flops": flops_tiles.subject_flops(self.shape, tile, count, m["enc"],
                                                        m["dec"], m["svf_res"], m["int_steps"]),
                "blend_bytes": flops_tiles.blend_bytes(self.shape, tile, count, m["int_res"])}
        counts = getattr(self.reg, "tile_counts", None)
        if counts and self.calls:
            info["slots"] = counts["slots"] / self.calls
        return info

    def check(self) -> dict:
        ops.no_tf32()
        worst, refs = {}, {}
        with torch.no_grad():
            for n, (moved, field) in sorted(self.sample, key=lambda s: s[0] % self.t["pairs"]):
                p = n % self.t["pairs"]
                if p not in refs:
                    refs.clear()
                    refs[p] = ref_tiles.register(self.weights, self.mov[p], self.fix[p],
                                                 self.model, self.tiling["subvol_size"],
                                                 self.tiling["min_perc_overlap"])
                for name, v in pairs.pair_gaps(moved, field, *refs[p]).items():
                    if name not in worst or not v <= worst[name]:  # NaN stays
                        worst[name] = v
        return worst


control_config = pairs.control_config


@contextlib.contextmanager
def flat_blend():
    """A planted fault: every weight of the program's blend is 1, so that
    each tile's field counts as much at its edge as at its centre."""
    from multimodal_registration_torch.infer import blend

    real = blend.pyramid_weights
    blend.pyramid_weights = lambda shape: np.ones_like(real(shape))
    try:
        yield
    finally:
        blend.pyramid_weights = real


FAULTS = {"flat_blend": flat_blend}
