"""The registration forward's share of the card's bf16 peak, in %: the
forward's FLOPs (``perfbench/flops.py``, counted from the cell's shape and
widths) times the pairs a second of the untraced load just before the
traced window, over 989 TFLOP/s; every FLOP against the one bf16 peak, so
the reading does not move when work moves between units (the model step;
moves ``pairs_per_s``)."""

from perfbench.flops import PEAK_BF16_FLOPS


def read(trace):
    if not trace.rate:
        return None
    return 100.0 * trace.info["unit_flops"] * trace.rate / PEAK_BF16_FLOPS
