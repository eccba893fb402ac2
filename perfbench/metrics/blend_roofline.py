"""The blend at its bandwidth roofline, in %: the least bytes of a subject's
blend (``perfbench/flops_tiles.py::blend_bytes``: each tile's field read
once, the blended field written once) at 3.35 TB/s, over the device time a
subject of the operations launched under the program's span
``registrar.blend`` (the tile blend; moves the tile cell's rate)."""

from perfbench import program_spans as ps
from perfbench.flops import PEAK_HBM_BYTES


def read(trace):
    iv = ps.intervals(trace, "registrar.blend")
    ms = None if iv is None else ps.per_unit_ms(trace, ps.device_s(trace, iv))
    if not ms or "blend_bytes" not in trace.info:
        return None
    return 100.0 * trace.info["blend_bytes"] / PEAK_HBM_BYTES / (ms * 1e-3)
