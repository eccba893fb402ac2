"""Tracing and step timing.

Counterpart of ``multimodal_registration_tpu/utils/profiling.py``:
:func:`device_trace` records a ``torch.profiler`` trace (the card's kernels
when a card is present) and writes it as a Chrome trace; :class:`StepTimer`
keeps one JSON-lines record per step, with the same records, file lines and
``summary()`` as the JAX package's, and can wait for the card before it
reads the clock.

:func:`span` marks the boundaries of the port's layers (the registrar, the
model's forward, the training step). A span records only while a torch
profiler records, and costs one check of the profiler's state otherwise.
Under the profiler it is one record in an in-memory ring that :func:`spans`
returns, on the profiler's own host clock, and a range of the profiler's
function scope: a trace of every scope (``torch.profiler.profile``,
:func:`device_trace`) shows it among the operators. It is no
``record_function`` range (the user scope) on purpose: the profiler projects
those onto the device's timeline as operations of their own, which a reader
of the user scope's device operations would count as work.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


class _Ring:
    """The newest records, and a count of those pushed out."""

    def __init__(self, size: int):
        self.records = deque(maxlen=size)
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, rec: tuple) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)


_RING = _Ring(1 << 17)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "sid", "parent", "root", "start", "rf", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.sid = next(_IDS)
        outer = stack[-1] if stack else None
        self.parent = outer.sid if outer else 0
        self.root = outer.root if outer else self.sid
        # the profiler's host events are stamped on the Unix-epoch clock
        self.start = time.time_ns()
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.stack = stack
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.stack.pop()
        try:
            self.rf.__exit__(*exc)
        finally:
            _RING.add((self.name, self.start, time.time_ns(), self.sid, self.parent,
                       self.root, threading.get_ident()))
        return False


class _Listened:
    """A span that also tells the thread's listener where it opens and
    closes (:func:`listening`)."""

    __slots__ = ("name", "listener", "inner")

    def __init__(self, name: str, listener):
        self.name, self.listener = name, listener

    def __enter__(self):
        self.listener.enter(self.name)
        self.inner = _Span(self.name) if _profiler_enabled() else _OFF
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.inner.__exit__(*exc)
        finally:
            self.listener.exit(self.name)
        return False


def span(name: str):
    """A context over one layer's work named ``name``: while a torch profiler
    records, a range of the profiler's function scope and one record of
    :func:`spans`; otherwise one shared no-op context. Spans nest by thread; the spans of
    one call or step share the ``root_id`` of the outermost. Under
    :func:`listening` the listener hears it open and close, profiler or not."""
    listener = getattr(_LOCAL, "listener", None)
    if listener is not None:
        return _Listened(name, listener)
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def listening(listener):
    """In the block, every span of the calling thread calls
    ``listener.enter(name)`` as it opens and ``listener.exit(name)`` as it
    closes (``utils/graphs.py`` cuts a captured forward into graphs there);
    ``None`` leaves the spans as they are."""
    if listener is None:
        yield
        return
    _LOCAL.listener = listener
    try:
        yield
    finally:
        _LOCAL.listener = None


def spans() -> list:
    """The recorded spans in the order they ended, ``(name, start_ns,
    end_ns, span_id, parent_id, root_id, thread_id)``, the times from
    ``time.time_ns()``, the clock of the profiler's host events. The ring
    keeps the newest 2**17."""
    with _RING.lock:
        return list(_RING.records)


def dropped() -> int:
    """How many records the ring has pushed out since the process began."""
    return _RING.dropped


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block; yields the path of the Chrome trace (``.json``,
    readable by ``chrome://tracing``, Perfetto and TensorBoard's profiler)
    that is written into ``log_dir`` when the block exits."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@dataclass
class StepTimer:
    """Rolling step timing with JSON-lines output (one record per step).
    With ``sync`` (a CUDA device), :meth:`stop` waits for that device's work
    before it reads the clock, so a record holds the step's device time."""

    path: str | None = None
    sync: torch.device | str | None = None
    _t0: float = field(default=0.0, repr=False)
    records: list = field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, **labels) -> float:
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        dt = time.perf_counter() - self._t0
        rec = {"seconds": dt, **labels}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return dt

    def summary(self) -> dict:
        if not self.records:
            return {}
        xs = sorted(r["seconds"] for r in self.records)
        n = len(xs)
        return {
            "n": n,
            "mean": sum(xs) / n,
            "p50": xs[n // 2],
            "p90": xs[min(n - 1, int(0.9 * n))],
            "min": xs[0],
            "max": xs[-1],
        }
