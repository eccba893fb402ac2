"""Device ms a step of the operations launched under the optimizer's span
(clipping and Adam; moves ``train_steps_per_s``)."""


def read(trace):
    ops = trace.under("optimizer")
    if not ops or not trace.units:
        return None
    return 1e3 * trace.device_s(ops) / trace.units
