"""Typed training configuration, drop-in compatible with the reference's
``config/config.json`` and key for key with
``multimodal_registration_tpu/train/config.py::TrainConfig``."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TrainConfig:
    # data organisation
    model_dir: str = "models"
    log_dir: str = "logs"
    bool_sub_dir: bool = False
    sub_dir: str = "train_ex"
    # label-map generation
    gen_label_only: bool = False
    gen_label: bool = True
    save_label: bool = True
    label_dir: str = "labels"
    zero_borders_maps: bool = False
    zero_borders_maps_val: bool = False
    zero_bord_scale: int = 8
    zero_bord_frac: float = 0.5
    in_shape: List[int] = field(default_factory=lambda: [160, 160, 192])
    num_labels: int = 26
    num_maps: int = 100
    im_scales: List[float] = field(default_factory=lambda: [16, 32, 64])
    def_scales: List[float] = field(default_factory=lambda: [8, 16, 32])
    im_max_std: float = 1.0
    def_max_std: float = 3.0
    add_str: str = "26lab_"
    # grayscale image generation
    same_subj: bool = True
    blur_std: float = 1.0
    gamma: float = 0.25
    vel_std: float = 3.0
    # scalar or list: the two-step recipe trains the smooth step-1 model with
    # vel_res [32, 64] (noise summed over both Perlin scales)
    vel_res: float | List[float] = 16.0
    bias_std: float = 0.3
    bias_res: float = 40.0
    # training
    gpu: str = "0"
    epochs: int = 600
    batch_size: int = 1
    train_frac: float = 0.8
    batch_size_val: int = 1
    save_freq: int = 100
    bool_init_weights: bool = False
    init_weights: str = "model.h5"
    reg_param: float = 1.0
    lr: float = 1e-4
    init_epoch: int = 0
    verbose: int = 1
    # network architecture
    int_steps: int = 5
    int_res: int = 2
    svf_res: int = 2
    enc: List[int] = field(default_factory=lambda: [64, 64, 64, 64])
    dec: List[int] = field(default_factory=lambda: [64, 64, 64, 64, 64, 64])
    # extensions (not in the reference config; safe defaults)
    seed: int = 42
    compute_dtype: str = "bfloat16"
    num_devices: Optional[int] = None  # more than one is not ported yet
    # global-norm gradient clipping; 0 disables
    grad_clip_norm: float = 0.0
    # type of the gathered values in the full-res composed-field warp of the
    # loss ("" = float32); the accumulation stays float32
    compose_payload_dtype: str = "bfloat16"
    # resolution divisor for the generator+model field composition in the
    # loss: 2 composes the generator's small-grid field with the model's
    # int-res warp at that small grid and upsamples the result once (it falls
    # back to full resolution when the two reduced grids do not nest);
    # 1 always composes at full resolution (strict reference parity)
    compose_res: int = 2
    # integration-grid divisor for the generator's augmentation SVF
    svf_int_res: int = 4
    # resolution divisor for the smoothness regulariser: 2 penalises the
    # model's int-res warp instead of its full-res upsample (the same loss up
    # to boundary terms); 1 = reference semantics
    grad_res: int = 1

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path) as f:
            data = json.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
