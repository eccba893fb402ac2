"""Device ms a pair of the operations launched under the flow head's span
(``VxmDense.flow_head``, the float32 conv; moves ``pairs_per_s``)."""


def read(trace):
    ops = trace.under("flow_head")
    if not ops or not trace.units:
        return None
    return 1e3 * trace.device_s(ops) / trace.units
