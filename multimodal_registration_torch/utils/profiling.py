"""Tracing and step timing.

Counterpart of ``multimodal_registration_tpu/utils/profiling.py``:
:func:`device_trace` records a ``torch.profiler`` trace (the card's kernels
when a card is present) and writes it as a Chrome trace; :class:`StepTimer`
keeps one JSON-lines record per step, with the same records, file lines and
``summary()`` as the JAX package's, and can wait for the card before it
reads the clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch


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
