"""CUDA graphs of the inference forward: captured once per input key and
replayed segment by segment, at the model's layer boundaries.

:meth:`ForwardGraphs.run` decides, for each forward that
``Registrar.predict_tensors`` runs, whether it runs eager, is captured or is
replayed. A forward is a chain of segments, each marked by :func:`segment`
inside the Python call that runs it eager: the U-Net inside ``Unet.forward``
(so that the module's hooks and the span ``vxm.unet`` enclose it), the flow
head inside ``VxmDense.flow_head``, the SVF's rescale and smoothing, the
integration inside ``ops/integrate.py::integrate_svf_batch``, and the rest of
``VxmDense.tail``. A segment is captured as one CUDA graph per stretch between
the program's spans (``utils/profiling.py::span``), and a replay opens the
same spans around each graph: every span encloses the same device work as in
the eager forward, and a trace gives each operation to the same layer (a
graph's kernels carry the correlation id of their ``cudaGraphLaunch``). A
segment reads the outputs of the segments before it at the addresses
captured; only what comes from outside the chain is written into buffers
fixed per key (:func:`static_copy`, :func:`static_cat`). The graphs of a key
share one memory pool and always replay in the order of their capture.

With no forward captured or replayed on the calling thread every function
here runs its argument as it is: the CPU, ``impl="plain"``, training,
validation, the sharded forward and direct calls of the model never meet a
graph.
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from collections import OrderedDict

import torch

from multimodal_registration_torch import kernels
from multimodal_registration_torch.utils import profiling
from multimodal_registration_torch.utils.profiling import span

_LOCAL = threading.local()  # .run: the forward this thread captures or replays
_CAPTURE_LOCK = threading.Lock()  # one capture at a time on a device's capture stream
_STREAMS: dict = {}  # device -> the side stream forwards are captured on
_HELD: list = []  # the caches whose entries captured kernels read by address
_SEEN, _FAILED, _MISSING = object(), object(), object()


def held(cache: dict) -> dict:
    """Register ``cache``, a dict of device operands that kernels read by
    address (K1's and K8's prepared weights, K5's scratch, device constants),
    and return it. A key's graphs keep every entry those caches held when it
    was captured, so that evicting one cannot free memory a replay reads."""
    _HELD.append(cache)
    return cache


def _run():
    return getattr(_LOCAL, "run", None)


def segment(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, one segment of the forward: run as it is,
    captured (while :class:`ForwardGraphs` captures the forward on this
    thread) or replayed (while it replays, returning the captured outputs).
    A segment called inside another one is part of it."""
    run = _run()
    if run is None:
        return fn(*args, **kwargs)
    return run.segment(name, fn, args, kwargs)


def static_copy(name: str, src: torch.Tensor) -> torch.Tensor:
    """``src`` itself, or, in a forward captured or replayed, its values in
    the key's buffer ``name`` (an input that comes from outside the chain)."""
    run = _run()
    if run is None:
        return src
    buf = run.static(name)
    if buf is not None:
        return buf.copy_(src)
    return run.keep(name, src.clone(memory_format=torch.contiguous_format))


def static_cat(name: str, tensors, dim: int) -> torch.Tensor:
    """``torch.cat(tensors, dim)``, in a forward captured or replayed written
    into the key's buffer ``name``."""
    run = _run()
    if run is None:
        return torch.cat(tensors, dim)
    buf = run.static(name)
    if buf is not None:
        return torch.cat(tensors, dim, out=buf)
    return run.keep(name, torch.cat(tensors, dim))


def _signature(args, kwargs) -> tuple:
    """What a segment was called with: its tensors by address, the rest by value."""
    flat = (*args, *(x for kv in sorted(kwargs.items()) for x in kv))
    return tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in flat)


def _replay(graph, names) -> None:
    if names:
        with span(names[0]):
            _replay(graph, names[1:])
    else:
        graph.replay()


class _Segment:
    __slots__ = ("name", "sig", "pieces", "out")

    def __init__(self, name: str, sig: tuple):
        self.name, self.sig, self.pieces, self.out = name, sig, [], None


class _Graphs:
    """One key's capture: its pool, its inputs from outside the chain, its
    segments (graphs and the spans open around each), the counted launches of
    one forward, and the operands it keeps alive."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.statics: dict = {}
        self.segments: list = []
        self.launches: dict = {}
        self.held: list = []


class _Run:
    """One forward being captured into ``graphs`` or replayed from it. While
    it captures it listens to the program's spans: each span that opens or
    closes inside a segment ends the graph being captured and begins the
    next."""

    def __init__(self, graphs: _Graphs, replay: bool):
        self.graphs, self.replay = graphs, replay
        self.i = 0
        self.seg = None  # the segment being captured
        self.stack = []  # the spans open inside it
        self.graph = None

    def static(self, name: str):
        if self.seg is not None:
            raise RuntimeError(f"input {name!r} of the chain taken inside segment {self.seg.name!r}")
        return self.graphs.statics.get(name) if self.replay else None

    def keep(self, name: str, t: torch.Tensor) -> torch.Tensor:
        self.graphs.statics[name] = t
        return t

    def segment(self, name, fn, args, kwargs):
        sig = _signature(args, kwargs)
        if self.replay:
            seg = self.graphs.segments[self.i] if self.i < len(self.graphs.segments) else None
            if seg is None or seg.name != name or seg.sig != sig:
                raise RuntimeError(f"the forward left its captured chain at segment {name!r}")
            self.i += 1
            for graph, names in seg.pieces:
                _replay(graph, names)
            return seg.out
        if self.seg is not None:
            return fn(*args, **kwargs)
        self.seg = seg = _Segment(name, sig)
        self._begin()
        try:
            seg.out = fn(*args, **kwargs)
        finally:
            try:
                self._end()
            finally:
                self.seg = None
        self.graphs.segments.append(seg)
        return seg.out

    # the span listener (utils/profiling.py::listening)
    def enter(self, name: str) -> None:
        if self.seg is not None:
            self._end()
            self.stack.append(name)
            self._begin()

    def exit(self, name: str) -> None:
        if self.seg is not None:
            self._end()
            self.stack.pop()
            self._begin()

    def _begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.graphs.pool, capture_error_mode="thread_local")

    def _end(self) -> None:
        graph, self.graph = self.graph, None
        if graph is None:  # a failed capture, being unwound
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        # a stretch that launched nothing (two spans back to back) needs no graph
        if not any("graph is empty" in str(w.message).lower() for w in caught):
            self.seg.pieces.append((graph, tuple(self.stack)))


@contextlib.contextmanager
def _running(run: _Run):
    _LOCAL.run = run
    try:
        with profiling.listening(None if run.replay else run):
            yield run
    finally:
        _LOCAL.run = None


def _capture_stream(device: torch.device):
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


class ForwardGraphs:
    """The forwards of one registrar as CUDA graphs, decided from what can be
    observed; no switch turns them on. :meth:`run` takes a forward's key
    (None: run it eager) and the state it depends on:

    * the first forward of a key runs eager, as without graphs; the second is
      captured: it runs eager on the capture stream first (so that what is
      made once per stream, prepared weights and library handles, is made
      there), which gives its outputs, then the forward is captured; later
      forwards of the key replay;
    * at most ``MAX_KEYS`` keys are held, a key seen once among them; a new
      key releases the one used least recently, and with it its pool;
    * a change of the state (the int8 scales' version, the parameters'
      addresses and versions) drops every key;
    * a key whose capture raises runs eager from then on.

    ``counts`` counts forwards: ``captures``, ``replays`` and ``eager``. A
    replay adds the launches its graphs hold to ``kernels.launch_counts()``
    and ``entry_launch_counts()``, as the eager forward counts them; the
    capture counts none (the forward that ran eager before it did)."""

    MAX_KEYS = 4

    def __init__(self, device, params=None):
        self.device = torch.device(device)
        self.params = params  # () -> the tensors the forward reads, kept by each capture
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._keys: OrderedDict = OrderedDict()
        self._state = None
        self._lock = threading.Lock()

    def action(self, key, state) -> str:
        """``"eager"``, ``"capture"`` or ``"replay"`` for a forward of ``key``
        under ``state``, as the policy says (and as it records)."""
        if state != self._state:
            self.clear()
            self._state = state
        entry = self._keys.get(key, _MISSING)
        if entry is _MISSING:
            self._keys[key] = _SEEN
            if len(self._keys) > self.MAX_KEYS:
                self._release(self._keys.popitem(last=False)[1])
            return "eager"
        self._keys.move_to_end(key)
        if entry is _SEEN:
            return "capture"
        return "eager" if entry is _FAILED else "replay"

    def captured(self) -> int:
        """How many keys hold graphs."""
        return sum(isinstance(e, _Graphs) for e in self._keys.values())

    def clear(self) -> None:
        """Drop every key, releasing the graphs' pools."""
        if any(isinstance(e, _Graphs) for e in self._keys.values()):
            torch.cuda.synchronize(self.device)  # no replay still reads them
        self._keys.clear()

    def _release(self, entry) -> None:
        if isinstance(entry, _Graphs):
            torch.cuda.synchronize(self.device)

    def run(self, key, state, forward):
        """``forward()``, eager, captured or replayed for ``key``."""
        with self._lock:
            act = "eager" if key is None else self.action(key, state)
            if act == "replay":
                return self._replay(self._keys[key], forward)
            if act == "capture":
                return self._capture(key, forward)
            self.counts["eager"] += 1
        return forward()

    def _replay(self, graphs: _Graphs, forward):
        run = _Run(graphs, replay=True)
        with _running(run):
            out = forward()
        if run.i != len(graphs.segments):
            raise RuntimeError("the forward replayed only part of its captured chain")
        kernels.add_launches(graphs.launches)
        self.counts["replays"] += 1
        return out

    def _capture(self, key, forward):
        cur = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        graphs = None
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = forward()
                with span("registrar.graph_capture"):
                    try:
                        graphs = _Graphs()
                        with _running(_Run(graphs, replay=False)), \
                                kernels.diverted_launches() as counted:
                            forward()
                        graphs.launches = counted
                        graphs.held = [tuple(c.values()) for c in _HELD]
                        if self.params is not None:
                            graphs.held.append(tuple(self.params()))
                    except Exception as e:  # noqa: BLE001 - any failure leaves the key eager
                        warnings.warn(f"the forward {key} could not be captured as CUDA "
                                      f"graphs and runs eager: {e}")
                        graphs = None
            cur.wait_stream(side)
        self.settle(key, graphs)
        return out

    def settle(self, key, graphs) -> None:
        """Record how the capture of ``key`` ended: its graphs, or None if it
        raised (the key runs eager from then on); count its forward."""
        self._keys[key] = _FAILED if graphs is None else graphs
        self.counts["eager" if graphs is None else "captures"] += 1
