"""K8's quantize pass at its bandwidth roofline, in %: the least bytes of a
pair's quantize passes (``perfbench/flops_int8.py::quantize_bytes``) at
3.35 TB/s, over the device time a pair of the operations launched under the
program's span ``int8.quantize`` (the int8 convs; moves ``pairs_per_s``)."""

from perfbench import program_spans as ps
from perfbench.flops import PEAK_HBM_BYTES


def read(trace):
    iv = ps.intervals(trace, "int8.quantize")
    ms = None if iv is None else ps.per_unit_ms(trace, ps.device_s(trace, iv))
    if not ms or "quantize_bytes" not in trace.info:
        return None
    return 100.0 * trace.info["quantize_bytes"] / PEAK_HBM_BYTES / (ms * 1e-3)
