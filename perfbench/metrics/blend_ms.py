"""Device ms a subject of the operations launched under the program's span
``registrar.blend`` (``infer/register.py::blend_tiles``: the pyramid blend
of the tiles' fields; the tile blend; moves the tile cell's rate)."""

from perfbench import program_spans as ps


def read(trace):
    iv = ps.intervals(trace, "registrar.blend")
    return None if iv is None else ps.per_unit_ms(trace, ps.device_s(trace, iv))
