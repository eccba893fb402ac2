"""Device-idle ms a pair inside the host intervals of the program's span
``registrar.predict_tensors``: the part of the idle window that the
registrar's and the model's own host work leaves, not the caller's (the
launch path; moves ``pairs_per_s`` and ``pairs_per_s.w256``)."""

from perfbench import program_spans as ps


def read(trace):
    iv = ps.intervals(trace, "registrar.predict_tensors")
    return None if iv is None else ps.per_unit_ms(trace, ps.idle_s(trace, iv))
