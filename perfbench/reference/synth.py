"""Plain float32 reference of SynthMorph's training-pair synthesis, as the
port's trainer configures it (``config/config.json``: no zero borders,
``svf_int_res`` 4): random axis flips shared by source and target, then for
each of the two label maps a random smooth deformation (multi-scale noise on
the quarter grid, scaling and squaring, a 4x resize), the linearly warped
one-hot map and the nearest-warped labels, per-label Gaussian intensities,
a blur, a multiplicative bias field, min-max scaling and a gamma.

The random numbers are drawn from the caller's ``torch.Generator`` in the
program's order and shapes (the draws are the inputs both sides are given);
all arithmetic after the draws is this file's own, in float32.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import ops

ENGINE = {"mean_min": 25.0, "mean_max": 225.0, "std_min": 5.0, "std_max": 25.0,
          "zero_background": 0.2, "int_steps": 5, "blur_radius": 3}


def _uniform(gen, size, lo, hi, device):
    return lo + (hi - lo) * torch.rand(size, generator=gen, device=device)


def _perlin_draws(gen, shape, scale, max_std, device):
    """One scale of multi-scale noise: a std ~ U(0, max_std) and unit
    normals at ``ceil(spatial / scale)``."""
    std = max_std * torch.rand((), generator=gen, device=device)
    small = tuple(int(math.ceil(d / scale)) for d in shape[:3])
    return std, torch.randn((*small, shape[3]), generator=gen, device=device)


def _perlin(std, noise, shape):
    n = noise * std
    zoom = tuple(o / s for o, s in zip(shape[:3], n.shape[:3]))
    return ops.resize(n, zoom, shape[:3])


def draw_sample(gen, shape, cfg: dict, device) -> dict:
    """Every random number of one synthesised image, in the program's order."""
    L, r = cfg["num_labels"], cfg["svf_int_res"]
    small = tuple(s // r for s in shape)
    d = {"svf": _perlin_draws(gen, (*small, 3), cfg["vel_res"] / r, cfg["vel_std"], device),
         "means": _uniform(gen, (L,), ENGINE["mean_min"], ENGINE["mean_max"], device),
         "stds": _uniform(gen, (L,), ENGINE["std_min"], ENGINE["std_max"], device),
         "zero_bg": _uniform(gen, (), 0.0, 1.0, device),
         "noise": torch.randn(tuple(shape), generator=gen, device=device),
         "blur": _uniform(gen, (), 0.0, cfg["blur_std"], device)}
    d["bias"] = _perlin_draws(gen, (*shape, 1), cfg["bias_res"], cfg["bias_std"], device)
    d["gamma"] = torch.randn((), generator=gen, device=device)
    return d


def draw_pair(gen, device) -> torch.Tensor:
    """The flip mask: ``m ~ U{0..3}`` axes, chosen by a random permutation."""
    m = torch.randint(0, 4, (), generator=gen, device=device)
    return torch.randperm(3, generator=gen, device=device) < m


def flip(mask: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    for ax in range(3):
        vol = torch.where(mask[ax], torch.flip(vol, dims=(ax,)), vol)
    return vol


def image(labels: torch.Tensor, d: dict, cfg: dict) -> dict:
    """One synthesised image from a label map ``(X, Y, Z)`` and its draws:
    ``img``, the soft warped one-hot ``soft (X, Y, Z, L)``, and the
    generator's quarter-grid field ``phi_small`` (its own grid's units)."""
    shape = tuple(labels.shape)
    L, r, dev = cfg["num_labels"], cfg["svf_int_res"], labels.device
    small = tuple(s // r for s in shape)
    svf = _perlin(*d["svf"], (*small, 3)) / r
    # the generator's field is gathered in bfloat16, as the synthesis states
    # (``ImageEngineConfig.integrate_payload_dtype``): it makes the data
    phi_small = ops.integrate(svf[None], ENGINE["int_steps"], torch.bfloat16)[0]
    phi = ops.rescale_field(phi_small, float(r), shape)
    n = shape[0] * shape[1] * shape[2]
    coords = (ops.grid(shape, dev) + phi).reshape(1, n, 3)
    flat = labels.reshape(1, n).long()
    soft = torch.zeros((1, n, L), dtype=torch.float32, device=dev)
    for idx, w in ops.corners(shape, coords):
        soft.scatter_add_(2, torch.gather(flat, 1, idx)[..., None], w[..., None])
    hi = torch.tensor(shape, dtype=torch.float32, device=dev) - 1
    near = torch.round(torch.minimum(torch.clamp(coords, min=0.0), hi)).long()
    hard = torch.gather(flat, 1, (near[..., 0] * shape[1] + near[..., 1]) * shape[2]
                        + near[..., 2]).reshape(shape)

    means, stds = d["means"], d["stds"]
    keep = torch.ones(L, dtype=torch.bool, device=dev)
    keep[0] = False
    keep = keep | ~(d["zero_bg"] < ENGINE["zero_background"])
    means = torch.where(keep, means, torch.zeros_like(means))
    stds = torch.where(keep, stds, torch.zeros_like(stds))
    img = means[hard] + stds[hard] * d["noise"]
    img = ops.gaussian_blur(img, d["blur"], ENGINE["blur_radius"])
    img = img * torch.exp(_perlin(*d["bias"], (*shape, 1))[..., 0])
    lo, hi_v = img.min(), img.max()
    img = (img - lo) / torch.clamp(hi_v - lo, min=1e-7)
    img = torch.pow(torch.clamp(img, 1e-7, 1.0), torch.exp(cfg["gamma"] * d["gamma"]))
    return {"img": img, "soft": soft.reshape(*shape, L), "phi_small": phi_small}
