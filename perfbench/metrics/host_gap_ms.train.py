"""Device-idle ms a step inside the host intervals of the program's span
``train.step`` (``Trainer.train_step``; the training step; moves
``train_steps_per_s``)."""

from perfbench import program_spans as ps


def read(trace):
    iv = ps.intervals(trace, "train.step")
    return None if iv is None else ps.per_unit_ms(trace, ps.idle_s(trace, iv))
