"""K8's conv at its int8 roofline, in %: the int8 operations of a pair's
int8 convs (``perfbench/flops_int8.py::int8_ops``) at 1,979 TOP/s, over the
device time a pair of the operations launched under the program's span
``int8.conv`` (the int8 convs; moves ``pairs_per_s``)."""

from perfbench import program_spans as ps
from perfbench.flops_int8 import PEAK_INT8_OPS


def read(trace):
    iv = ps.intervals(trace, "int8.conv")
    ms = None if iv is None else ps.per_unit_ms(trace, ps.device_s(trace, iv))
    if not ms or "int8_ops" not in trace.info:
        return None
    return 100.0 * trace.info["int8_ops"] / PEAK_INT8_OPS / (ms * 1e-3)
