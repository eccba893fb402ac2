"""Device ms a step of the operations launched under the span of
``loss_from_batch`` (the forward and the loss; moves ``train_steps_per_s``)."""


def read(trace):
    ops = trace.under("loss")
    if not ops or not trace.units:
        return None
    return 1e3 * trace.device_s(ops) / trace.units
