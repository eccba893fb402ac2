"""Device ms a pair of the operations launched under the program's span
``vxm.tail`` (``VxmDense.tail``: the rescales, K2's squaring steps, the
full-res field and K3; the model tail; moves ``pairs_per_s`` and
``pairs_per_s.w256``)."""

from perfbench import program_spans as ps


def read(trace):
    iv = ps.intervals(trace, "vxm.tail")
    return None if iv is None else ps.per_unit_ms(trace, ps.device_s(trace, iv))
