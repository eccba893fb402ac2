"""The program's own spans in a traced window, for the per-layer readers.

The port records a span at each of its layers' boundaries while a torch
profiler records (``multimodal_registration_torch/utils/profiling.py::span``:
``registrar.*``, ``vxm.*``, ``train.*``), in memory, on the clock of the
profiler's host events. A span's records are kept when their host interval
lies inside the traced window; a device operation belongs to a span when its
launch lies in the span's interval, as for the benchmark's own spans
(``perfbench/trace.py``). Every function returns None where there is nothing
to read: a program without these spans, a window that holds none of the
name, or a ring that may have pushed out records of the window.
"""

from __future__ import annotations

import bisect


def intervals(trace, name: str):
    """The host intervals ``(start, end)`` in ns of the program's spans
    ``name`` inside the window, sorted; None if there are none, or if the
    ring dropped a record that may have ended inside the window."""
    from multimodal_registration_torch.utils import profiling

    read, dropped = getattr(profiling, "spans", None), getattr(profiling, "dropped", None)
    if read is None or dropped is None:
        return None
    recs = read()
    w0, w1 = trace.window
    # the ring keeps records in the order they ended: what it pushed out
    # ended before its oldest record did
    if dropped() and (not recs or recs[0][2] >= w0):
        return None
    iv = sorted((s, e) for n, s, e, *_ in recs if n == name and w0 <= s and e <= w1)
    return iv or None


def merged(iv: list) -> list:
    """The union of sorted intervals, as disjoint sorted intervals."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_s(trace, iv: list):
    """Device seconds of the operations launched inside the intervals
    ``iv``; None if no operation was."""
    union = merged(iv)
    starts = [s for s, _ in union]
    total = found = 0
    for op in trace.ops:
        i = bisect.bisect_right(starts, op[3]) - 1
        if i >= 0 and op[3] <= union[i][1]:
            total += op[2]
            found += 1
    return total * 1e-9 if found else None


def idle_s(trace, iv: list):
    """Seconds of the window in which no device operation ran, counted
    where they overlap the intervals ``iv``; None if the window holds no
    device operation."""
    if not trace.ops:
        return None
    w0, w1 = trace.window
    idle, prev = [], w0
    for s, e in trace.busy() + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    total, j = 0, 0
    union = merged(iv)
    for s, e in idle:
        while j < len(union) and union[j][1] <= s:
            j += 1
        k = j
        while k < len(union) and union[k][0] < e:
            total += min(e, union[k][1]) - max(s, union[k][0])
            k += 1
    return total * 1e-9


def per_unit_ms(trace, seconds):
    """Milliseconds a unit (pair, step) of ``seconds``; None where there
    is no reading or no unit."""
    if seconds is None or not trace.units:
        return None
    return 1e3 * seconds / trace.units
