"""Multi-scale ("Perlin") noise drawn on the device.

Counterpart of ``multimodal_registration_tpu/synth/perlin.py``
(``ne.utils.augment.draw_perlin``): for each scale ``s``, Gaussian noise of
shape ``ceil(spatial / s)`` with a std drawn uniformly from ``[min_std,
max_std]`` is resized trilinearly (corner-aligned) to the output shape, and
the scales are summed. ONE std is drawn per scale and shared by all channels.

A ``torch.Generator`` cannot replay ``jax.random``'s streams, so the function
is split: :func:`draw_perlin_randoms` draws, :func:`perlin_from_randoms`
computes from given draws (the parity tests hand it the arrays that the JAX
function drew), and :func:`draw_perlin` is the two together.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from multimodal_registration_torch.ops.resize import resize


def _scales(scales):
    return [scales] if isinstance(scales, (int, float)) else list(scales)


def _split_shape(out_shape):
    out_shape = tuple(int(s) for s in out_shape)
    chan = out_shape[3:]
    return out_shape, out_shape[:3], (int(math.prod(chan)) if chan else 1)


def sample_shapes(out_shape: Sequence[int], scales) -> list:
    """Shape ``(*ceil(spatial / s), nchan)`` of each scale's noise."""
    _, spatial, nchan = _split_shape(out_shape)
    return [(*(int(math.ceil(d / s)) for d in spatial), nchan) for s in _scales(scales)]


def draw_perlin_randoms(gen: torch.Generator, out_shape, scales, min_std: float = 0.0,
                        max_std: float = 1.0, stds=None, device=None) -> dict:
    """The random numbers of one :func:`draw_perlin` call: ``stds`` (one
    scalar tensor per scale, the given ones if ``stds`` is not ``None``) and
    ``noises`` (unit normals, one ``(*ceil(spatial / s), nchan)`` per scale)."""
    scales = _scales(scales)
    if stds is not None and len(stds) != len(scales):
        raise ValueError(f"need one std per scale: {len(stds)} vs {len(scales)}")
    out_stds, noises = [], []
    for i, shp in enumerate(sample_shapes(out_shape, scales)):
        if stds is not None:
            out_stds.append(torch.as_tensor(stds[i], dtype=torch.float32, device=device))
        else:
            u = torch.rand((), generator=gen, device=device)
            out_stds.append(min_std + (max_std - min_std) * u)
        noises.append(torch.randn(shp, generator=gen, device=device))
    return {"stds": out_stds, "noises": noises}


def perlin_from_randoms(randoms: dict, out_shape, scales) -> torch.Tensor:
    """Multi-scale noise ``out_shape = (X, Y, Z, [C...])`` from the draws of
    :func:`draw_perlin_randoms`."""
    out_shape, spatial, nchan = _split_shape(out_shape)
    total = None
    for std, noise, scale in zip(randoms["stds"], randoms["noises"], _scales(scales)):
        noise = noise * std
        sample_spatial = tuple(noise.shape[:3])
        if sample_spatial != spatial:
            zoom = tuple(o / s for o, s in zip(spatial, sample_spatial))
            noise = resize(noise, zoom, out_shape=spatial)
        total = noise if total is None else total + noise
    return total.reshape(out_shape)


def draw_perlin(gen: torch.Generator, out_shape, scales, min_std: float = 0.0,
                max_std: float = 1.0, stds=None, device=None) -> torch.Tensor:
    """Draw multi-scale noise of shape ``out_shape``; trailing dims are
    channels. ``stds`` (one scalar per scale) overrides the internal draw."""
    randoms = draw_perlin_randoms(gen, out_shape, scales, min_std, max_std, stds, device)
    return perlin_from_randoms(randoms, out_shape, scales)
