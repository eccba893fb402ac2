"""Pair-generator augmentations, on the device.

Counterpart of ``multimodal_registration_tpu/synth/augment.py``:
  * random axis flips, the same subset of axes for source and target (the
    subset size m ~ U{0..ndim}, the m axes chosen without replacement);
  * ``random_zero_borders``: per axis, a 50/50 coin between "no crop" and a
    random crop of up to ``1/scale`` of the axis on each side; voxels outside
    the box are zeroed;
  * ``maybe_zero_borders``: that with probability ``frac``.

Each is split into a part that draws (``draw_*``) and a part that computes
from given draws (``apply_*``), for the parity tests. Nothing here moves a
value to the host: flips are selects on a drawn mask.
"""

from __future__ import annotations

import torch


def draw_flip_mask(gen: torch.Generator, ndim: int = 3, device=None) -> torch.Tensor:
    """Boolean ``(ndim,)``: exactly m axes set, m ~ U{0..ndim}."""
    m = torch.randint(0, ndim + 1, (), generator=gen, device=device)
    ranks = torch.randperm(ndim, generator=gen, device=device)
    return ranks < m


def apply_flips(flip_mask: torch.Tensor, vols, axis_offset: int = 0):
    out = []
    for v in vols:
        for ax in range(flip_mask.shape[0]):
            v = torch.where(flip_mask[ax], torch.flip(v, dims=(ax + axis_offset,)), v)
        out.append(v)
    return tuple(out)


def random_flips(gen: torch.Generator, vols, ndim: int = 3, axis_offset: int = 0):
    """Flip a random subset of spatial axes, the same for every volume."""
    return apply_flips(draw_flip_mask(gen, ndim, vols[0].device), vols, axis_offset)


def draw_zero_border_box(gen: torch.Generator, shape, scale: int = 8, device=None) -> torch.Tensor:
    """Int64 ``(3, 2)``: per axis the box ``[lo, hi)`` kept by
    :func:`random_zero_borders`."""
    box = []
    for dim in shape[:3]:
        lo_rand = torch.randint(0, max(dim // scale, 1), (), generator=gen, device=device)
        keep_lo = torch.rand((), generator=gen, device=device) < 0.5
        hi_rand = torch.randint((scale - 1) * dim // scale, dim, (), generator=gen, device=device)
        keep_hi = torch.rand((), generator=gen, device=device) < 0.5
        lo = torch.where(keep_lo, torch.zeros_like(lo_rand), lo_rand)
        hi = torch.where(keep_hi, torch.full_like(hi_rand, dim), hi_rand)
        box.append(torch.stack([lo, hi]))
    return torch.stack(box)


def apply_zero_borders(box: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    mask = None
    for ax, dim in enumerate(vol.shape[:3]):
        idx = torch.arange(dim, device=vol.device)
        m = (idx >= box[ax, 0]) & (idx < box[ax, 1])
        m = m.reshape([dim if a == ax else 1 for a in range(3)])
        mask = m if mask is None else mask & m
    mask = mask.reshape(*mask.shape, *([1] * (vol.ndim - 3)))
    return torch.where(mask, vol, torch.zeros((), dtype=vol.dtype, device=vol.device))


def random_zero_borders(gen: torch.Generator, vol: torch.Tensor, scale: int = 8) -> torch.Tensor:
    """Zero voxels outside a random box (crop-then-zero-pad mimicry)."""
    return apply_zero_borders(draw_zero_border_box(gen, vol.shape, scale, vol.device), vol)


def maybe_zero_borders(gen: torch.Generator, vol: torch.Tensor, scale: int,
                       frac: float) -> torch.Tensor:
    """Apply :func:`random_zero_borders` with probability ``frac``."""
    coin = torch.rand((), generator=gen, device=vol.device)
    zeroed = random_zero_borders(gen, vol, scale)
    return torch.where(coin < frac, zeroed, vol)
