"""Device ms a step of the operations launched under the spans of
``draw_batch`` and ``build_batch`` (the synthesis; moves
``train_steps_per_s``)."""


def read(trace):
    ops = trace.under("draw_batch") + trace.under("build_batch")
    if not ops or not trace.units:
        return None
    return 1e3 * trace.device_s(ops) / trace.units
