"""The traced run: spans the benchmark installs around calls into the
program's layers, the profiler's device trace, and the reduction of both to
what the per-layer readers take.

A span is a ``torch.profiler.record_function`` range named ``bench.<layer>``
around a call: a wrapper the benchmark sets on an object it built, or on a
module attribute the program looks up when it calls. A device operation
(kernel, copy or fill) belongs to a span when the host call that launched it
(its CUDA runtime event, matched by correlation id) lies inside the span's
host interval, whatever thread launched it; no span is keyed on a kernel's
name. The trace is read in memory from the profiler's events: no trace file
is written. The profiler records on the host only those spans and the CUDA
runtime's calls (:func:`profiled`), so that it slows the host little.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch
from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope,
                                _ExperimentalConfig)
from torch.profiler import record_function

PREFIX = "bench."
WINDOW = PREFIX + "window"
_MISSING = object()


class Spans:
    """Installs span wrappers and takes them away again on :meth:`close`."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, attr: str, layer: str) -> None:
        """Make ``owner.attr`` (a module attribute or an object's method) run
        inside the span ``bench.<layer>``."""
        fn = getattr(owner, attr)
        name = PREFIX + layer

        def spanned(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        self._undo.append((owner, attr, vars(owner).get(attr, _MISSING)))
        setattr(owner, attr, spanned)

    def hook(self, module: torch.nn.Module, layer: str) -> None:
        """The span ``bench.<layer>`` around every call of ``module``."""
        name = PREFIX + layer
        state = []

        def pre(_m, _a):
            rf = record_function(name)
            rf.__enter__()
            state.append(rf)

        def post(_m, _a, _o):
            state.pop().__exit__(None, None, None)

        self._undo.append(module.register_forward_pre_hook(pre))
        self._undo.append(module.register_forward_hook(post))

    def close(self) -> None:
        for item in reversed(self._undo):
            if isinstance(item, tuple):
                owner, attr, prev = item
                if prev is _MISSING:
                    delattr(owner, attr)
                else:
                    setattr(owner, attr, prev)
            else:
                item.remove()
        self._undo.clear()


_RUNTIME = ("cuda", "cu")  # CUDA runtime and driver calls, which launch device work


class Trace:
    """What one traced window holds: the window, the spans by name (host
    ``(start, end)`` in ns), and the device operations ``(name, start, dur,
    launch, kind)`` with ``kind`` one of ``kernel``, ``memcpy``, ``memset``.
    ``units`` is the count of completed units (pairs, steps), ``info`` what
    the driver knows of one unit's work (FLOPs, bytes), ``rate`` the units a
    second of the same load untraced, just before (None if not run)."""

    def __init__(self, window, spans, ops, units: int, info: dict, unmatched: int = 0,
                 rate: float | None = None):
        self.window = window
        self.spans = spans
        self.ops = ops
        self.units = units
        self.info = info
        self.rate = rate
        self.unmatched = unmatched
        self._starts = {k: [s for s, _ in v] for k, v in spans.items()}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def in_span(self, layer: str, t: int) -> bool:
        name = PREFIX + layer
        starts = self._starts.get(name)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= self.spans[name][i][1]

    def under(self, layer: str) -> list:
        """The device operations launched inside the span ``bench.<layer>``."""
        return [op for op in self.ops if self.in_span(layer, op[3])]

    def device_s(self, ops) -> float:
        return sum(op[2] for op in ops) * 1e-9

    def host_s(self, layer: str) -> float:
        return sum(e - s for s, e in self.spans.get(PREFIX + layer, [])) * 1e-9

    def count(self, layer: str) -> int:
        return len(self.spans.get(PREFIX + layer, []))

    def busy(self) -> list:
        """Merged intervals in which a device operation ran, inside the window."""
        w0, w1 = self.window
        iv = sorted((max(s, w0), min(s + d, w1)) for _, s, d, _, _ in self.ops
                    if s + d > w0 and s < w1)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def open_span(self, t: int) -> str:
        """The innermost benchmark span open on the host at ``t``."""
        best, best_start = "none", None
        for name, iv in self.spans.items():
            if name == WINDOW:
                continue
            starts = self._starts[name]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1] and (best_start is None or iv[i][0] > best_start):
                best, best_start = name[len(PREFIX):], iv[i][0]
        return best

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(int)
        for name, _, d, _, _ in self.ops:
            by_name[name[:200]] += d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        w0, w1 = self.window
        prev = w0
        for s, e in self.busy() + [[w1, w1]]:
            if s > prev:
                gaps.append((s - prev, prev))
            prev = max(prev, e)
        gaps.sort(reverse=True)
        return {"device_ops": [[n, d * 1e-9] for n, d in ops],
                "idle_gaps": [[self.open_span(t), d * 1e-9] for d, t in gaps[:top]]}


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def parse(events, units: int, info: dict, rate: float | None = None) -> Trace:
    """A :class:`Trace` from the profiler's events (``_ProfilerResult.events()``)."""
    launches = {}
    spans = defaultdict(list)
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(PREFIX):
                spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(_RUNTIME):
                launches[e.correlation_id()] = e.start_ns()
        elif not name.startswith(PREFIX):
            # a device operation carries its launch's CUDA correlation id (an
            # annotation's projection onto the device carries none of its own)
            corr = e.correlation_id()
            if corr:
                device.append((name, e.start_ns(), e.duration_ns(), corr))
    ops, unmatched = [], 0
    for name, start, dur, corr in device:
        launch = launches.get(corr)
        if launch is None:
            unmatched += 1
            launch = start
        ops.append((name, start, dur, launch, _kind(name)))
    for v in spans.values():
        v.sort()
    if WINDOW not in spans:
        raise RuntimeError("the trace holds no window span")
    window = spans[WINDOW][0]
    ops = [op for op in ops if window[0] <= op[3] <= window[1]]
    return Trace(window, dict(spans), ops, units, info, unmatched, rate)


@contextlib.contextmanager
def profiled():
    """The profiler over the host and the card; yields a function that
    returns its events once the block has closed. On the host it records the
    benchmark's spans (``record_function``, the user scope) and the CUDA
    runtime's calls, not every operator: recording each of those would slow
    the host and so the window it measures."""
    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    result = []
    try:
        yield lambda: result[0].events()
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        result.append(_disable_profiler())
