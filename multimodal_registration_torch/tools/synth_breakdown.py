"""Synthesis time attribution at the reference workload (160x160x192, 26 labels).

    python -m multimodal_registration_torch.tools.synth_breakdown [iters] [--small]
        [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/synth_breakdown.py``. Times nested
prefixes of one sample of the image engine (``synth/image_engine.py``, its
default configuration, ``svf_int_res`` 2), each chained ``iters`` times on one
``torch.Generator`` after a warm-up call; stage k runs stages 0..k and each
stage draws its own random numbers:

  ``perlin_svf`` (the SVF's Perlin draw at half res) -> ``integrate`` (5
  squaring steps, bf16 payload, K2) -> ``rescale`` (to full res) ->
  ``label_warp`` (soft and hard maps in one launch of K6) -> ``intensity``
  (per-label means and stds, gathered, + noise) -> ``blur`` -> ``bias``
  (Perlin field, ``exp``, product) -> ``norm_gamma`` (min-max, gamma).

Rows ``cum_<stage>_ms`` (the prefix) and ``delta_<stage>_ms`` (its
difference to the previous prefix); ``aug_pair_ms``, flips and zero borders
of a pair of label maps; ``synth_pair_ms``, the trainer's two-image
synthesis of one sample (:func:`synthesize`, both generators' SVFs
integrated in one batch), the cross-check against ``train_breakdown``'s
``synth_ms``. One JSON line a stage, then the whole record. ``--small``:
32x32x48, 8 labels. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.ops.integrate import integrate_svf
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_labels_soft_hard
from multimodal_registration_torch.synth.augment import maybe_zero_borders, random_flips
from multimodal_registration_torch.synth.image_engine import (
    ImageEngineConfig,
    _gaussian_blur,
    _vel_scales,
    payload_dtype,
)
from multimodal_registration_torch.synth.perlin import draw_perlin
from multimodal_registration_torch.tools.timing import card_note, ms_per_call, note, write_result
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import synthesize

STAGES = ("perlin_svf", "integrate", "rescale", "label_warp",
          "intensity", "blur", "bias", "norm_gamma")


def sample_upto(stage: int, gen, lab, cfg: ImageEngineConfig):
    """Stages 0..``stage`` of one sample's synthesis from ``lab (X, Y, Z)``;
    returns the live outputs of the last one."""
    shape = tuple(lab.shape)
    dev = lab.device
    L = cfg.num_labels
    r = cfg.svf_int_res
    small = tuple(s // r for s in shape)

    def uniform(size, lo, hi):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev)

    svf = draw_perlin(gen, (*small, 3), _vel_scales(cfg, r), max_std=cfg.vel_std, device=dev)
    if stage == 0:
        return svf
    phi_small = integrate_svf(svf / r, cfg.int_steps, payload_dtype(cfg))
    if stage == 1:
        return phi_small
    phi = rescale_field(phi_small, float(r), out_shape=shape)
    if stage == 2:
        return phi
    soft, lab_idx = warp_labels_soft_hard(lab, phi, L)
    if stage == 3:
        return phi, soft, lab_idx
    means = uniform((L,), cfg.mean_min, cfg.mean_max)
    stds = uniform((L,), cfg.std_min, cfg.std_max)
    keep = torch.ones(L, dtype=torch.bool, device=dev)
    keep[0] = False
    keep = keep | ~(uniform((), 0.0, 1.0) < cfg.zero_background)
    means = torch.where(keep, means, torch.zeros_like(means))
    stds = torch.where(keep, stds, torch.zeros_like(stds))
    idx = lab_idx.long()
    img = means[idx] + stds[idx] * torch.randn(shape, generator=gen, device=dev)
    if stage == 4:
        return phi, soft, img
    img = _gaussian_blur(img, uniform((), 0.0, cfg.blur_std), cfg.blur_radius)
    if stage == 5:
        return phi, soft, img
    bias = draw_perlin(gen, (*shape, 1), [cfg.bias_res], max_std=cfg.bias_std, device=dev)
    img = img * torch.exp(bias[..., 0])
    if stage == 6:
        return phi, soft, img
    lo, hi = img.min(), img.max()
    img = (img - lo) / torch.clamp(hi - lo, min=1e-7)
    g = torch.exp(cfg.gamma * torch.randn((), generator=gen, device=dev))
    return phi, soft, torch.pow(torch.clamp(img, 1e-7, 1.0), g)


@torch.no_grad()
def run(iters: int = 8, small: bool = False, device=None, emit=print) -> dict:
    """Measure the stages, the pair augmentation and the pair synthesis."""
    dev = resolve_device(device)
    shape = (32, 32, 48) if small else (160, 160, 192)
    L = 8 if small else 26
    cfg = ImageEngineConfig(num_labels=L)
    rng = np.random.default_rng(0)
    lab = torch.as_tensor(rng.integers(0, L, size=shape, dtype=np.uint8), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    res = {"shape": list(shape), "labels": L}
    prev = 0.0
    for i, name in enumerate(STAGES):
        t = ms_per_call(dev, lambda i=i: sample_upto(i, gen, lab, cfg), iters)
        res[f"cum_{name}_ms"] = t
        res[f"delta_{name}_ms"] = t - prev
        emit(json.dumps({name: t, "delta": t - prev}))
        prev = t

    tcfg = TrainConfig.from_dict(dict(in_shape=list(shape), num_labels=L, batch_size=1,
                                      epochs=1, zero_borders_maps=True))

    def aug_only():
        s, t = random_flips(gen, (lab, lab))
        return (maybe_zero_borders(gen, s, tcfg.zero_bord_scale, tcfg.zero_bord_frac),
                maybe_zero_borders(gen, t, tcfg.zero_bord_scale, tcfg.zero_bord_frac))

    res["aug_pair_ms"] = ms_per_call(dev, aug_only, iters)
    emit(json.dumps({"aug_pair_ms": res["aug_pair_ms"]}))
    res["synth_pair_ms"] = ms_per_call(
        dev, lambda: synthesize(gen, lab[None], lab[None], cfg, tcfg, True), iters)
    emit(json.dumps(res))
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", nargs="?", type=int, default=8)
    ap.add_argument("--small", action="store_true", help="32x32x48 / 8 labels")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    res = run(a.iters, a.small, dev)
    write_result(a.out, res)
    return res


if __name__ == "__main__":
    main()
