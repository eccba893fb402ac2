"""Device operations (kernels, copies, fills) a pair, launched under the
spans of the calls (the launch path; moves ``pairs_per_s``)."""


def read(trace):
    ops = trace.under("call")
    calls = trace.count("call")
    if not ops or not calls:
        return None
    return len(ops) / calls
