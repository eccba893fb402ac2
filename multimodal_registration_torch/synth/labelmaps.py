"""Random label-map synthesis on the device.

Counterpart of ``multimodal_registration_tpu/synth/labelmaps.py``
(``generate_label_maps`` of the reference trainer): draw a multi-channel
Perlin noise image (one channel per label), deform each channel by its own
Perlin warp, and take the voxelwise argmax to obtain a uint8 label map.

The warp draws follow the reference: the ``(X, Y, Z, L, nd)`` warp tensor is
sampled at ``ceil(axis / scale)`` on every axis but the last, the label axis
included, so neighbouring labels get smoothly correlated warps. The coarse
noise is drawn once per scale and each label's slice is interpolated along
the label axis before the spatial resize. Channels are processed in a loop
that keeps only one channel's temporaries and the running argmax live.

:func:`draw_label_map_randoms` draws, :func:`label_map_from_randoms`
computes from given draws, :func:`generate_label_map` is the two together.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from multimodal_registration_torch.device import full_fp32_matmuls
from multimodal_registration_torch.ops.resize import _interp_matrix, resize
from multimodal_registration_torch.ops.warp import warp
from multimodal_registration_torch.synth.perlin import (
    draw_perlin_randoms,
    perlin_from_randoms,
)


def _shape3(in_shape):
    in_shape = tuple(int(s) for s in in_shape)
    if len(in_shape) not in (2, 3):
        raise ValueError(f"in_shape must be 2-D or 3-D, got {in_shape}")
    return in_shape, (in_shape if len(in_shape) == 3 else (*in_shape, 1))


def draw_label_map_randoms(gen: torch.Generator, in_shape, num_labels: int,
                           im_scales=(16, 32, 64), def_scales=(8, 16, 32),
                           im_max_std: float = 1.0, def_max_std: float = 3.0,
                           device=None) -> dict:
    """The random numbers of one label map: ``im_stds`` and ``def_stds`` (one
    uniform std per scale, shared by all labels), ``im_noises`` (per label,
    the unit normals of each image scale) and ``def_noises`` (per warp scale,
    unit normals ``(*ceil(shape / s), ceil(L / s), ndim)``)."""
    in_shape, shape3 = _shape3(in_shape)
    L = int(num_labels)
    im_scales, def_scales = tuple(im_scales), tuple(def_scales)
    im_stds = im_max_std * torch.rand(len(im_scales), generator=gen, device=device)
    def_stds = def_max_std * torch.rand(len(def_scales), generator=gen, device=device)
    im_noises = [
        draw_perlin_randoms(gen, (*shape3, 1), im_scales, stds=im_stds, device=device)["noises"]
        for _ in range(L)
    ]
    def_noises = []
    for s in def_scales:
        cs = tuple(int(math.ceil(d / s)) for d in shape3)
        cl = max(1, int(math.ceil(L / s)))
        def_noises.append(torch.randn((*cs, cl, len(in_shape)), generator=gen, device=device))
    return {"im_stds": im_stds, "def_stds": def_stds, "im_noises": im_noises,
            "def_noises": def_noises}


def _warp_for_label(l, coarse_noises, label_weights, shape3):
    """Label ``l``'s warp field from the shared coarse draws: its coarse
    slice interpolated along the label axis, then resized spatially."""
    wf = None
    for noise, W in zip(coarse_noises, label_weights):
        with full_fp32_matmuls():
            sl = torch.einsum("c,xyzcd->xyzd", W[l], noise)
        if tuple(sl.shape[:3]) != tuple(shape3):
            zoom = tuple(o / s for o, s in zip(shape3, sl.shape[:3]))
            sl = resize(sl, zoom, out_shape=shape3)
        wf = sl if wf is None else wf + sl
    return wf


def label_map_from_randoms(randoms: dict, in_shape, num_labels: int,
                           im_scales=(16, 32, 64), def_scales=(8, 16, 32),
                           impl=None) -> torch.Tensor:
    """One uint8 label map (values in ``[0, num_labels)``) from the draws of
    :func:`draw_label_map_randoms`; 2-D shapes run as a single-plane volume
    with a zero z-displacement."""
    in_shape, shape3 = _shape3(in_shape)
    ndim = len(in_shape)
    L = int(num_labels)
    im_scales, def_scales = tuple(im_scales), tuple(def_scales)
    dev = randoms["im_stds"].device
    coarse = [n * randoms["def_stds"][i] for i, n in enumerate(randoms["def_noises"])]
    weights = [torch.as_tensor(_interp_matrix(L, n.shape[3], L / n.shape[3]), device=dev)
               for n in coarse]
    best = lab = None
    for l in range(L):
        im = perlin_from_randoms(
            {"stds": list(randoms["im_stds"]), "noises": randoms["im_noises"][l]},
            (*shape3, 1), im_scales)[..., 0]
        wf = _warp_for_label(l, coarse, weights, shape3)
        if ndim == 2:  # zero z-component: the displacement stays in-plane
            wf = torch.cat([wf, torch.zeros((*shape3, 1), dtype=wf.dtype, device=dev)], dim=-1)
        warped = warp(im, wf, interp="linear", impl=impl)
        if best is None:
            best, lab = warped, torch.zeros(shape3, dtype=torch.uint8, device=dev)
        else:
            take = warped > best  # strict: argmax keeps the first maximum
            best = torch.where(take, warped, best)
            lab = torch.where(take, torch.full_like(lab, l), lab)
    return lab if ndim == 3 else lab[..., 0]


def generate_label_map(gen: torch.Generator, in_shape: Sequence[int], num_labels: int,
                       im_scales=(16, 32, 64), def_scales=(8, 16, 32),
                       im_max_std: float = 1.0, def_max_std: float = 3.0,
                       device=None, impl=None) -> torch.Tensor:
    """One uint8 label map on ``device``; ``in_shape`` 3-D or 2-D."""
    randoms = draw_label_map_randoms(gen, in_shape, num_labels, im_scales, def_scales,
                                     im_max_std, def_max_std, device)
    return label_map_from_randoms(randoms, in_shape, num_labels, im_scales, def_scales, impl)


def generate_label_maps(gen: torch.Generator, num_maps: int, in_shape, num_labels: int,
                        device=None, **kwargs) -> list:
    """``num_maps`` maps as numpy uint8 arrays (made on ``device``)."""
    with torch.no_grad():
        return [np.asarray(generate_label_map(gen, in_shape, num_labels, device=device,
                                              **kwargs).cpu())
                for _ in range(num_maps)]
