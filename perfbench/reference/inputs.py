"""The benchmark's inputs, made on the device from the seed: a bank of smooth
label maps and registration pairs of two contrasts.

Label maps follow SynthMorph's recipe (Hoffmann et al., IEEE TMI 2022; the
reference trainer's ``generate_label_maps``): one multi-scale noise image a
label, each deformed by its own smooth random warp, and the voxelwise argmax.
A pair takes one map: the fixed image gives each label a random intensity,
the moving image another one after the map is displaced by a smooth random
field of a few voxels, both with a little noise and scaled to [0, 1].
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import ops


def _noise(gen, shape, scale, std, device) -> torch.Tensor:
    """Normal noise drawn at ``ceil(shape / scale)`` and resized up to
    ``shape`` (``(X, Y, Z, C)``), times ``std``."""
    small = tuple(int(math.ceil(s / scale)) for s in shape[:3])
    n = torch.randn((*small, shape[3]), generator=gen, device=device) * std
    return ops.resize(n, tuple(o / s for o, s in zip(shape[:3], small)), shape[:3])


def label_map(gen, shape, num_labels: int, im_scales, def_scales, im_max_std: float = 1.0,
              def_max_std: float = 3.0, device=None) -> torch.Tensor:
    """One uint8 label map ``shape`` with values in ``[0, num_labels)``."""
    im_std = im_max_std * torch.rand(len(im_scales), generator=gen, device=device)
    def_std = def_max_std * torch.rand(len(def_scales), generator=gen, device=device)
    best = lab = None
    for label in range(num_labels):
        im = sum(_noise(gen, (*shape, 1), s, im_std[i], device) for i, s in enumerate(im_scales))
        field = sum(_noise(gen, (*shape, 3), s, def_std[i], device)
                    for i, s in enumerate(def_scales))
        warped = ops.warp(im[None], field[None])[0, ..., 0]
        if best is None:
            best, lab = warped, torch.zeros(shape, dtype=torch.uint8, device=device)
        else:
            take = warped > best
            best = torch.where(take, warped, best)
            lab = torch.where(take, torch.full_like(lab, label), lab)
    return lab


def label_bank(seed: int, count: int, shape, num_labels: int, im_scales, def_scales,
               device) -> torch.Tensor:
    """``(count, X, Y, Z)`` uint8 label maps from ``seed``."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 1) % (2 ** 63))
    with torch.no_grad():
        return torch.stack([label_map(gen, tuple(shape), num_labels, im_scales, def_scales,
                                      device=device) for _ in range(count)])


def _contrast(gen, labels: torch.Tensor, num_labels: int, noise_std: float) -> torch.Tensor:
    means = torch.rand(num_labels, generator=gen, device=labels.device)
    img = means[labels.long()]
    img = img + noise_std * torch.randn(labels.shape, generator=gen, device=labels.device)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo)


def pairs(seed: int, bank: torch.Tensor, count: int, num_labels: int, shift_std: float,
          shift_scale: float, noise_std: float) -> tuple:
    """``(moving, fixed)``, each ``(count, X, Y, Z)`` float32 on the bank's
    device: pair ``i`` is drawn from map ``i mod len(bank)``."""
    dev = bank.device
    gen = torch.Generator(device=dev).manual_seed((int(seed) * 104729 + 2) % (2 ** 63))
    shape = tuple(bank.shape[1:])
    mov, fix = [], []
    with torch.no_grad():
        for i in range(count):
            lab = bank[i % bank.shape[0]]
            field = _noise(gen, (*shape, 3), shift_scale, shift_std, dev)
            coords = ops.grid(shape, dev) + field
            hi = torch.tensor(shape, device=dev) - 1
            near = torch.minimum(torch.clamp(torch.round(coords), min=0), hi).long()
            shifted = lab[near[..., 0], near[..., 1], near[..., 2]]
            fix.append(_contrast(gen, lab, num_labels, noise_std))
            mov.append(_contrast(gen, shifted, num_labels, noise_std))
    return torch.stack(mov), torch.stack(fix)
