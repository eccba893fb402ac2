"""Plain float32 reference of subvolume registration (``use_subvol`` of
``config/config_inference.json``): the volume cut into overlapping tiles,
each tile registered alone, the tiles' fields blended with pyramid weights,
and the whole moving volume warped by the blended field.

Written from the published description (``bids_registration.py:169-271`` of
ivadomed/multimodal-registration):

* **the grid**, per axis: ``count = int(S / (s - p s)) + 1`` tiles of size
  ``s`` over a volume of ``S`` voxels with the least overlap share ``p``;
  their overlap ``(s - S / count) count / (count - 1)`` voxels; the first
  tile starts at 0, each next one ``int(overlap)`` voxels before the last
  one's end, shifted back inside where it would overrun the volume; the
  tiles in x-major order;
* **the weights**: ``1 - max(|x|, |y|, |z|) / (max + 1)`` over the tile's
  voxel offsets ``-s/2 .. s/2 - 1`` from its centre;
* **the blend**: the weighted sum of the tiles' fields over the summed
  weights, a sum of zero taken as one;
* **the moved volume**: the blended half-resolution field rescaled by 2,
  vectors included (``vxm.utils.rescale_dense_transform``), then the moving
  volume warped by it, linearly.

Departures from the published text, each the configuration's own reading of
it: the tile size is floored to a multiple of 16 (the model's shape quantum),
and an overlap share outside ``(0, 1)`` is read as a percentage when it is at
least 1 (0.1 where that is not below 1) and as 0.1 when it is not positive;
the half-resolution fields blend on the halved volume with the tile
coordinates halved (integer division), as the published subvolume path does
for ``int_res`` 2; each tile's field is ``model.svf`` integrated by
``ops.integrate`` (its gathered values in the configuration's payload type,
as ``model.forward``), one tile at a time, so that it fits.
"""

from __future__ import annotations

import torch

from perfbench.reference import model as ref_model
from perfbench.reference import ops


def overlap_share(p: float) -> float:
    """The least overlap share as the configuration reads it."""
    if p >= 1:
        return p / 100 if p / 100 < 1 else 0.1
    return 0.1 if p <= 0 else p


def axis_starts(size: int, tile: int, p: float) -> list:
    """The tiles' first voxels along one axis of ``size`` voxels."""
    count = int(size / (tile - p * tile)) + 1
    overlap = (tile - size / count) * count / (count - 1) if count > 1 else 0.0
    starts, end = [], 0
    for i in range(count):
        lo = 0 if i == 0 else int(end - overlap)
        lo = min(lo, size - tile)  # shifted back inside the volume
        starts.append(lo)
        end = lo + tile
    return starts


def grid(vol_shape, subvol_size, min_perc_overlap) -> tuple:
    """``(tile shape, [(x0, x1, y0, y1, z0, z1)])`` of the tiles of a volume."""
    tile = tuple(int(s) // 16 * 16 for s in subvol_size)
    p = overlap_share(float(min_perc_overlap))
    if any(t > s for t, s in zip(tile, vol_shape)):
        raise ValueError(f"tiles {tile} larger than the volume {tuple(vol_shape)}")
    sx, sy, sz = (axis_starts(int(s), t, p) for s, t in zip(vol_shape, tile))
    coords = [(x, x + tile[0], y, y + tile[1], z, z + tile[2])
              for x in sx for y in sy for z in sz]
    return tile, coords


def pyramid(tile, device) -> torch.Tensor:
    """The weight of each voxel of a tile ``(x, y, z)``, computed in float64
    and stored in float32."""
    axes = [torch.arange(-(s // 2), s - s // 2, dtype=torch.float64, device=device)
            for s in tile]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    dist = torch.maximum(torch.maximum(gx.abs(), gy.abs()), gz.abs())
    return (1.0 - dist / (dist.max() + 1.0)).float()


def blend(fields, coords, tile, vol_shape, weights=None) -> torch.Tensor:
    """The blended field ``(X, Y, Z, 3)`` of tile fields ``(T, x, y, z, 3)``
    that start at ``coords[t][0::2]``; ``weights`` defaults to the pyramid."""
    dev = fields.device
    w = pyramid(tile, dev) if weights is None else weights
    total = torch.zeros(tuple(vol_shape), dtype=torch.float32, device=dev)
    acc = torch.zeros((*vol_shape, 3), dtype=torch.float32, device=dev)
    for f, co in zip(fields, coords):
        box = tuple(slice(co[2 * a], co[2 * a] + tile[a]) for a in range(3))
        total[box] += w
        acc[box] += f.float() * w[..., None]
    total = torch.where(total == 0, torch.ones_like(total), total)
    return acc / total[..., None]


def register(weights: dict, moving: torch.Tensor, fixed: torch.Tensor, model: dict,
             subvol_size, min_perc_overlap) -> tuple:
    """``(moved (X, Y, Z), field (X/2, Y/2, Z/2, 3))`` of one pair of ``(X,
    Y, Z)`` volumes registered tile by tile."""
    ref_model._check(model)
    vol_shape = tuple(moving.shape)
    tile, coords = grid(vol_shape, subvol_size, min_perc_overlap)
    fields = []
    for x0, x1, y0, y1, z0, z1 in coords:
        m = moving[x0:x1, y0:y1, z0:z1][None]
        f = fixed[x0:x1, y0:y1, z0:z1][None]
        v = ref_model.svf(weights, m, f, model)
        fields.append(ops.integrate(v, model["int_steps"], ref_model._payload(model))[0])
    half = tuple(s // 2 for s in vol_shape)
    field = blend(torch.stack(fields), [tuple(c // 2 for c in co) for co in coords],
                  tuple(s // 2 for s in tile), half)
    full = ops.rescale_field(field, 2.0, vol_shape)
    moved = ops.warp(moving.float()[None, ..., None], full[None])[0, ..., 0]
    return moved, field
