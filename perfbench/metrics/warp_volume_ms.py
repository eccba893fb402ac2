"""Device ms a subject of the operations launched under the program's span
``registrar.warp_volume`` (``infer/register.py::warp_volume``: the blended
field's 2x rescale and the warp of the whole moving volume; the volume
warp; moves the tile cell's rate)."""

from perfbench import program_spans as ps


def read(trace):
    iv = ps.intervals(trace, "registrar.warp_volume")
    return None if iv is None else ps.per_unit_ms(trace, ps.device_s(trace, iv))
