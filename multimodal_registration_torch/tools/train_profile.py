"""Profiler attribution of the training step, by operation and by category.

    python -m multimodal_registration_torch.tools.train_profile [steps] [--small]
        [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/train_profile.py``: one warm-up
:meth:`Trainer.train_step` at the reference workload (160x160x192, 26
labels, ``zero_borders_maps``; ``--small`` 32x32x48, 8 labels), then
``steps`` steps (default 3) inside ``utils/profiling.py::device_trace``,
whose Chrome trace is read back. Prints one JSON line with the trace's
``lanes`` (its processes and threads), one a top operation by time per step
(``op``, ``ms_per_step``, ``count`` a step, ``cat``), and the rollup
``category_ms_per_step``, ``total_device_ms_per_step``, ``trace_dir``.

On the card the operations are the device's kernels, copies and fills, by
the time each took; the categories are ``conv`` (cuDNN's convolutions and
their gradients), the port's kernels by their K-names (``K1`` ..  ``K8``,
``kernels.py``), ``gather/scatter`` (other indexing), ``elementwise``,
``reduce``, ``copy`` (copies, concatenations, fills), ``rng``, ``matmul``
and ``other``. On the CPU there is no device: the rollup reads the host
operators' self time (their time less their children's), and the tool
says so on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile

import numpy as np

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.tools.timing import card_note, note, write_result
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import Trainer
from multimodal_registration_torch.utils.profiling import device_trace

# the port's kernels by their CUDA function names (csrc/*.cu)
K_NAMES = {
    "K1": ("conv3_lrelu_pool_wgmma_kernel", "conv3_lrelu_pool_kernel"),
    "K2": ("warp_kernel", "self_warp_add_kernel"),
    "K3": ("warp_up2x_kernel",),
    "K4": ("pool_bwd_kernel",),
    "K5": ("warp_bwd_kernel", "warp_bwd_tiled_kernel", "warp_bwd_finish_kernel",
           "self_warp_add_bwd_kernel", "self_warp_add_finish_kernel"),
    "K6": ("warp_labels_kernel", "warp_labels_dice_fwd_kernel", "warp_labels_dice_reduce_kernel"),
    "K7": ("warp_labels_bwd_kernel", "warp_labels_dice_bwd_kernel"),
    "K8": ("conv3_int8_wgmma_kernel", "quantize_act_kernel"),
}
_K_RE = [(k, re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(names) + r")(?![A-Za-z0-9_])"))
         for k, names in K_NAMES.items()]
_HOST_REDUCE = re.compile(r"aten::(sum|mean|amax|amin|max|min|norm|linalg_vector_norm|"
                          r"argmax|argmin|all|any|prod)$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def categorize(name: str) -> str:
    """The category of a device operation (or host operator) ``name``."""
    for k, rx in _K_RE:
        if rx.search(name):
            return k
    n = name.lower()
    if any(s in n for s in ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(s in n for s in ("philox", "distribution", "aten::normal_", "aten::uniform_",
                            "aten::randn", "aten::rand")):
        return "rng"
    if any(s in n for s in ("gather", "scatter", "index")):
        return "gather/scatter"
    if any(s in n for s in ("memcpy", "memset", "copy", "fill", "aten::cat", "aten::clone")):
        return "copy"
    if "reduce" in n or _HOST_REDUCE.match(n):
        return "reduce"
    if "gemm" in n or n in ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul"):
        return "matmul"
    if "elementwise" in n or "multi_tensor" in n or n.startswith("aten::"):
        return "elementwise"
    return "other"


def _self_times(events: list) -> list:
    """``(name, self ms)`` of host operator events: each event's duration less
    its children's on the same thread (events nest by time)."""
    out = []
    by_thread = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end, event, children's time]
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]:
                _, done, kids = stack.pop()
                out.append((done["name"], (done["dur"] - kids) / 1e3))
            if stack:
                stack[-1][2] += e["dur"]
            stack.append([e["ts"] + e["dur"], e, 0.0])
        while stack:
            _, done, kids = stack.pop()
            out.append((done["name"], (done["dur"] - kids) / 1e3))
    return out


def read_trace(path: str) -> tuple:
    """``(lanes, [(name, ms), ...], on_device)`` of a Chrome trace: the device
    operations when it has any, else the host operators' self times."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    lanes = sorted({str(e.get("args", {}).get("name", "")) for e in events
                    if e.get("ph") == "M" and e.get("name") in ("process_name", "thread_name")})
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [(e["name"], e["dur"] / 1e3) for e in timed
              if str(e.get("cat", "")).lower() in DEVICE_CATS]
    if device:
        return lanes, device, True
    host = [e for e in timed if str(e.get("cat", "")).lower() == "cpu_op"]
    return lanes, _self_times(host), False


def rollup(ops: list, steps: int, top: int = 40) -> tuple:
    """The top operations a step and the categories' ms a step."""
    totals, counts = {}, {}
    for name, ms in ops:
        totals[name] = totals.get(name, 0.0) + ms
        counts[name] = counts.get(name, 0) + 1
    per_step = {k: v / steps for k, v in totals.items()}
    rows = [{"op": name[:110], "ms_per_step": ms, "count": counts[name] // steps,
             "cat": categorize(name)}
            for name, ms in sorted(per_step.items(), key=lambda kv: -kv[1])[:top]]
    cats = {}
    for name, ms in per_step.items():
        c = categorize(name)
        cats[c] = cats.get(c, 0.0) + ms
    return rows, dict(sorted(cats.items(), key=lambda kv: -kv[1])), sum(per_step.values())


def run(steps: int = 3, small: bool = False, device=None, emit=print,
        trace_dir: str | None = None, width: int = 0) -> dict:
    """Trace ``steps`` steps; returns the rollup record, ``rows`` and
    ``on_device``. ``width`` (not a flag of the JAX script) sets enc/dec to
    ``[width] * 4`` / ``[width] * 6``, as ``train_bench --width`` does."""
    dev = resolve_device(device)
    shape = [32, 32, 48] if small else [160, 160, 192]
    L = 8 if small else 26
    widths = dict(enc=[width] * 4, dec=[width] * 6) if width else {}
    cfg = TrainConfig.from_dict(dict(in_shape=shape, num_labels=L, batch_size=1, epochs=1,
                                     zero_borders_maps=True, **widths))
    trainer = Trainer(cfg, device=dev)
    maps = np.random.default_rng(0).integers(0, L, size=(1, *shape), dtype=np.uint8)
    src, trg = trainer.put_batch(maps, maps.copy())
    gen = trainer.generator(0)
    trainer.train_step(gen, src, trg)  # warm-up outside the trace

    log_dir = trace_dir or tempfile.mkdtemp(prefix="mmreg_trace_")
    with device_trace(log_dir) as path:
        for _ in range(steps):
            aux = trainer.train_step(gen, src, trg)
        float(aux["loss"])
    lanes, ops, on_device = read_trace(path)
    if not on_device:
        note("# no device in the trace: the rollup reads the host operators' self time "
             "(CPU), not device time")
    rows, cats, total = rollup(ops, steps)
    emit(json.dumps({"lanes": lanes}))
    for row in rows:
        emit(json.dumps(row))
    rec = {"category_ms_per_step": cats, "total_device_ms_per_step": total,
           "trace_dir": os.path.dirname(path)}
    emit(json.dumps(rec))
    return {**rec, "lanes": lanes, "rows": rows, "on_device": on_device, "trace": path}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="32x32x48 / 8 labels")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    rec = run(a.steps, a.small, dev)
    write_result(a.out, rec)
    return rec


if __name__ == "__main__":
    main()
