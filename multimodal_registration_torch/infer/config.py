"""Inference configuration, drop-in compatible with the reference's
``config/config_inference.json``.

Counterpart of ``multimodal_registration_tpu/infer/config.py``: the same
keys, defaults and validation. ``sharding`` (``{"data": N, "space": M}``)
selects the multi-device registrar (``infer/sharded.py::make_registrar``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List


@dataclass
class InferenceConfig:
    use_subvol: bool = False
    subvol_size: List[int] = field(default_factory=lambda: [80, 80, 96])
    min_perc_overlap: float = 0.1
    int_steps: int = 5
    int_res: int = 2
    svf_res: int = 2
    enc: List[int] = field(default_factory=lambda: [256, 256, 256, 256])
    dec: List[int] = field(default_factory=lambda: [256, 256, 256, 256, 256, 256])
    warp_interpolation: str = "linear"
    resample_interpolation: str = "linear"
    compute_dtype: str = "bfloat16"
    # `floor16` reproduces the reference's shape quirk (floors instead of
    # ceiling to a multiple of 16); `ceil16` is the intended behaviour
    round_mode: str = "floor16"
    # multi-device layout {"data": N, "space": M}; empty = one device
    sharding: dict = field(default_factory=dict)
    cascade_compose_res: str = "full"
    svf_smooth_sigma: float = 0.0
    model1_svf_smooth_sigma: float | None = 3.0
    quantize: str = ""

    @classmethod
    def from_json(cls, path: str) -> "InferenceConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, data: dict) -> "InferenceConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown inference config keys: {sorted(unknown)}")
        cfg = cls(**data)
        if cfg.svf_smooth_sigma is None:  # JSON null = off
            cfg.svf_smooth_sigma = 0.0
        bad = set(cfg.sharding) - {"data", "space"}
        if bad:
            raise ValueError(f"unknown sharding keys: {sorted(bad)} (want data/space)")
        for k, v in cfg.sharding.items():
            if v is not None and (not isinstance(v, int) or isinstance(v, bool) or v < 1):
                raise ValueError(
                    f"sharding.{k} must be a positive integer (number of chips), got {v!r}")
        if cfg.quantize is None:
            cfg.quantize = ""
        if cfg.quantize not in ("", "int8"):
            raise ValueError(
                f"unknown quantize mode {cfg.quantize!r}: supported values are "
                "\"int8\" or \"\"/null (full precision)")
        return cfg

    def round16(self, x: int, axis: int | None = None) -> int:
        """Round a dim to the model's shape quantum (16, floor by default).
        With ``space`` sharding, axis 0 rounds to ``16 * space``."""
        q = 16
        if axis == 0:
            q *= max(1, int(self.sharding.get("space", 1) or 1))
        if self.round_mode == "ceil16":
            return int(-(-int(x) // q) * q)
        return int((int(x) // q) * q)

