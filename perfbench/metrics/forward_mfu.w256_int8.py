"""The int8 forward's share of the card's peaks, in %: the least time of a
pair, its int8 operations at the int8 peak and the rest of its FLOPs at the
bf16 peak (``perfbench/flops_int8.py``, ``perfbench/flops.py``), times the
pairs a second of the untraced load just before the traced window. The share
of the whole pair, which no unit's speed can take past 100 % (the model
step; moves ``pairs_per_s``)."""

from perfbench.flops import PEAK_BF16_FLOPS
from perfbench.flops_int8 import PEAK_INT8_OPS


def read(trace):
    if not trace.rate or "int8_ops" not in trace.info:
        return None
    q = trace.info["int8_ops"]
    least = q / PEAK_INT8_OPS + (trace.info["unit_flops"] - q) / PEAK_BF16_FLOPS
    return 100.0 * least * trace.rate
