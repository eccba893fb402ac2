"""The yardstick: peaks of the card and the work of one forward, counted
from shapes.

Peaks are NVIDIA's H100 SXM data sheet's dense rates at the full 700 W.
FLOPs and bytes follow the counting of the port's analytic roofline
(``multimodal_registration_torch/tools/roofline.py``), frozen here so that a
change to the program cannot change its own yardstick: a 3x3x3 conv costs
``2 * voxels * 27 * Cin * Cout``, a trilinear warp ``24 * C`` a voxel, the
half-to-full rescale a fixed 0.3 GFLOP that the total leaves out.
"""

from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12   # dense bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12   # device memory, bytes/s

F32 = 4


def forward_flops(shape, enc, dec, svf_res: int = 2, int_steps: int = 5) -> float:
    """FLOPs of one registration forward at ``shape`` (batch 1)."""
    if svf_res != 2:
        raise NotImplementedError("counted for svf_res 2 only")
    half = tuple(s // 2 for s in shape)
    total = 0.0
    cin, res = 2, tuple(shape)
    for c in enc:
        total += 2 * math.prod(res) * 27 * cin * c
        cin, res = c, tuple(s // 2 for s in res)
    n_up = len(enc) - 1
    for i, c in enumerate(dec):
        total += 2 * math.prod(res) * 27 * cin * c
        cin = c
        if i < n_up:
            res = tuple(s * 2 for s in res)
            cin += enc[len(enc) - 1 - i]
    hv = math.prod(half)
    total += 2 * hv * 27 * cin * 3          # the flow head
    total += int_steps * hv * 24 * 3        # scaling and squaring
    total += math.prod(shape) * 24          # the moved image
    return total


def integrate_bytes(shape, int_res: int = 2, int_steps: int = 5) -> float:
    """Least device-memory bytes of the scaling and squaring: each step
    gathers from the whole field of the step before, so no two steps fuse,
    and each reads and writes the float32 three-component field once (the
    bound of the port's fused squaring step)."""
    vox = math.prod(s // int_res for s in shape)
    return int_steps * 2 * vox * 3 * F32
