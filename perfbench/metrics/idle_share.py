"""Share of the traced window in which no device operation ran, in % (the
device layer). The reader of ``idle_share.pairs``, ``idle_share.host`` and
``idle_share.train``: each moves its cells' rate."""


def read(trace):
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
