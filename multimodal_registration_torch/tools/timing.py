"""Clocks, card notes and result files shared by the port's measurement tools.

A tool times its work with :func:`elapsed_s`: CUDA events around the work on
the card (the events wait for everything the work enqueued), the host clock
on the CPU, where every number is a CPU number and no device metric. Where
the JAX scripts chained PRNG keys and drained the chain with one scalar
readback, the port's tools chain their steps on one ``torch.Generator`` and
synchronise once, at the end event.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCHMARKS = os.path.join(ROOT, "benchmarks")


def elapsed_s(dev: torch.device, fn) -> float:
    """Seconds ``fn()`` takes: CUDA events on the card, the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def ms_per_call(dev: torch.device, fn, iters: int, warmup: int = 1, blocks: int = 1) -> float:
    """Milliseconds a call of ``fn()``: ``warmup`` calls, then the best of
    ``blocks`` blocks of ``iters`` calls back to back."""
    for _ in range(warmup):
        fn()

    def block():
        for _ in range(iters):
            fn()

    return min(elapsed_s(dev, block) for _ in range(blocks)) / iters * 1e3


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_mib(dev: torch.device) -> float | None:
    """Peak device memory since :func:`reset_peak` (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None


def card_note(dev: torch.device) -> str:
    """One ``#`` line naming what the numbers were taken on: the card, its
    power limit (``nvidia-smi``), torch and CUDA; or the CPU."""
    if dev.type != "cuda":
        return "# device cpu: the plain versions on the host, no device metric"
    note = (f"# device {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}")
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        note += "; " + "; ".join(smi.stdout.strip().splitlines())
    return note


def note(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def outside_benchmarks(path: str, flag: str) -> str:
    """``path`` made absolute; raises when it lies under ``benchmarks/``."""
    path = os.path.abspath(path)
    if os.path.commonpath([path, BENCHMARKS]) == BENCHMARKS:
        raise ValueError(f"{flag} {path}: the tools never write under {BENCHMARKS}")
    return path


def write_result(path: str | None, doc) -> None:
    """Write ``doc`` as JSON to ``path`` (``--out``); nothing without one.
    Never under ``benchmarks/``, whose files are the JAX package's results."""
    if not path:
        return
    path = outside_benchmarks(path, "--out")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
