"""Device ms a pair of the operations launched under the program's spans
``int8.quantize`` and ``int8.conv`` (``ops/conv_int8.py::conv3_int8``: K8's
quantize pass and conv; the int8 convs; moves ``pairs_per_s``)."""

from perfbench import program_spans as ps


def read(trace):
    iv = [ps.intervals(trace, n) for n in ("int8.quantize", "int8.conv")]
    if None in iv:
        return None
    return ps.per_unit_ms(trace, ps.device_s(trace, sorted(iv[0] + iv[1])))
