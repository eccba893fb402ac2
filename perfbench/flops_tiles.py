"""The yardstick of subvolume registration: the tile grid's count, the work
of one subject's tile forwards and the least bytes of the blend, counted
from shapes as ``perfbench/flops.py`` counts a forward (kept here so that a
change to the program cannot change it).

A subject of ``shape`` is cut into tiles by the published grid (per axis
``int(S / (s - p s)) + 1`` tiles of ``s`` voxels, ``p`` the least overlap
share); each tile runs the registration forward without its moved image;
the tiles' half-resolution fields are blended into one, by which the whole
moving volume is warped.
"""

from __future__ import annotations

import math

from perfbench import flops


def tile_count(shape, tile, min_perc_overlap: float = 0.1) -> int:
    """Tiles of the grid over a volume of ``shape``."""
    p = float(min_perc_overlap)
    return math.prod(int(s / (t - p * t)) + 1 for s, t in zip(shape, tile))


def subject_flops(shape, tile, count: int, enc, dec, svf_res: int = 2,
                  int_steps: int = 5) -> float:
    """FLOPs of one subject: ``count`` tile forwards (``flops.forward_flops``
    without the tile's moved image, 24 a voxel) and the warp of the whole
    moving volume (24 a voxel); the blend and the rescale are left out, as
    the forward's rescale is."""
    per_tile = flops.forward_flops(tile, enc, dec, svf_res, int_steps) - math.prod(tile) * 24
    return count * per_tile + math.prod(shape) * 24


def blend_bytes(shape, tile, count: int, int_res: int = 2) -> float:
    """Least device-memory bytes of the blend: each tile's float32
    three-component field at ``1/int_res`` read once, the blended field
    written once."""
    half = [s // int_res for s in tile]
    vol = [s // int_res for s in shape]
    return float((count * math.prod(half) + math.prod(vol)) * 3 * flops.F32)
