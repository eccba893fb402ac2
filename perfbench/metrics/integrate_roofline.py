"""The scaling and squaring's share of its roofline, in %: the least bytes
of its steps (``perfbench/flops.py::integrate_bytes``) at 3.35 TB/s, over
the device time of the operations launched under the span of
``integrate_svf_batch`` (``ops/integrate.py``: K2's fused steps; moves
``pairs_per_s``)."""

from perfbench.flops import PEAK_HBM_BYTES


def read(trace):
    ops = trace.under("integrate")
    calls = trace.count("integrate")
    if not ops or not calls:
        return None
    least = trace.info["integrate_bytes"] * calls / PEAK_HBM_BYTES
    return 100.0 * least / trace.device_s(ops)
