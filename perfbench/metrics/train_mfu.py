"""The training step's share of the card's bf16 peak, in %: three times the
forward's FLOPs (a conv's data and weight gradients each cost its forward)
times the steps a second of the untraced load just before the traced
window, over 989 TFLOP/s (the training step; moves ``train_steps_per_s``)."""

from perfbench.flops import PEAK_BF16_FLOPS


def read(trace):
    if not trace.rate:
        return None
    return 300.0 * trace.info["unit_flops"] * trace.rate / PEAK_BF16_FLOPS
