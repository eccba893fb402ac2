"""Pyramid-weighted blending of per-tile warp fields, on the device.

Counterpart of ``multimodal_registration_tpu/infer/blend.py``
(``get_def_field_from_subvol`` of the reference): a weight map ``1 -
max(|x|, |y|, |z|) / (max + 1)`` centred on the tile, accumulated with the
weighted tile fields into a full-volume weight buffer and field buffer,
zero-sum guarded, then normalised. The two buffers live on the device and
are updated in place, slice by slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device


@functools.lru_cache(maxsize=8)
def pyramid_weights(model_in_shape: tuple) -> np.ndarray:
    x, y, z = (s // 2 for s in model_in_shape)
    grid = np.mgrid[-x:x, -y:y, -z:z]
    w = np.maximum(np.abs(grid[0]), np.abs(grid[1]))
    w = np.maximum(w, np.abs(grid[2]))
    return (1.0 - w / (w.max() + 1.0)).astype(np.float32)


def blend_subvol_fields(model_in_shape: tuple, im_shape: tuple, coords: list, warps,
                        device=None) -> torch.Tensor:
    """The blended full-volume field ``(X, Y, Z, 3)`` float32 from per-tile
    fields ``warps`` (``(T, sx, sy, sz, 3)``: a tensor, blended on its
    device, or an array, on ``device``) whose tiles start at
    ``coords[t][0::2]``."""
    if isinstance(warps, torch.Tensor):
        warps = warps.float()
    else:
        warps = torch.as_tensor(np.asarray(warps, np.float32), device=resolve_device(device))
    dev = warps.device
    w_map = torch.as_tensor(pyramid_weights(tuple(int(s) for s in model_in_shape)), device=dev)
    im_shape = tuple(int(s) for s in im_shape)
    weights = torch.zeros(im_shape, dtype=torch.float32, device=dev)
    field = torch.zeros((*im_shape, 3), dtype=torch.float32, device=dev)
    wx = w_map[..., None]
    for t, co in enumerate(coords):
        box = tuple(slice(int(co[2 * a]), int(co[2 * a]) + w_map.shape[a]) for a in range(3))
        weights[box] += w_map
        field[box] += warps[t] * wx
    weights = torch.where(weights == 0, torch.ones((), device=dev), weights)  # zero-sum guard
    return field / weights[..., None]
