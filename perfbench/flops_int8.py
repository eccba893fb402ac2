"""The yardstick of the int8 mode: the int8 peak of the card, and the int8
work of one forward counted from shapes, as ``perfbench/flops.py`` counts
the rest (kept here so that a change to the program cannot change it).

A conv whose input has at least ``min_cin`` channels runs in int8 (the
configuration's rule): ``2 * voxels * 27 * Cin * Cout`` int8 operations, and
its quantize pass reads each input voxel's channels in the compute type and
writes them once as int8.
"""

from __future__ import annotations

import math

PEAK_INT8_OPS = 1979e12  # dense int8 on the tensor cores (H100 SXM data sheet)


def convs(shape, enc, dec, in_channels: int = 2) -> list:
    """``[(voxels, cin, cout)]`` of the U-Net's convs at input ``shape``
    (batch 1, ``svf_res`` 2), in the order they run."""
    out = []
    cin, res = in_channels, tuple(shape)
    for c in enc:
        out.append((math.prod(res), cin, c))
        cin, res = c, tuple(s // 2 for s in res)
    n_up = len(enc) - 1
    for i, c in enumerate(dec):
        out.append((math.prod(res), cin, c))
        cin = c
        if i < n_up:
            res = tuple(s * 2 for s in res)
            cin += enc[len(enc) - 1 - i]
    return out


def int8_ops(shape, enc, dec, min_cin: int = 64) -> float:
    """int8 operations of one forward's int8 convs."""
    return float(sum(2 * v * 27 * ci * co for v, ci, co in convs(shape, enc, dec)
                     if ci >= min_cin))


def quantize_bytes(shape, enc, dec, min_cin: int = 64, act_bytes: int = 2) -> float:
    """Least device-memory bytes of one forward's quantize passes: each int8
    conv's input read once in the compute type (``act_bytes``, bf16) and
    written once as int8."""
    return float(sum(v * ci * (act_bytes + 1) for v, ci, _ in convs(shape, enc, dec)
                     if ci >= min_cin))
