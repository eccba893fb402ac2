#!/usr/bin/env python
"""Headline benchmark of the PyTorch port: registered 192³ volume pairs per
second on one NVIDIA GPU.

The counterpart of ``bench.py`` for ``multimodal_registration_torch``, name
for name: the same ``SHAPE``, ``ARCHS``, metric names, flags and output
contract. With no ``--arch`` it prints three JSON lines to stdout, infer256
in bf16, infer256 in int8, then the train64 headline last::

    {"metric": ..., "value": N, "unit": "pairs/s", "vs_baseline": N}

and nothing else to stdout; notes, block times, launch counts and peak
memory go to stderr as ``#`` lines.

Each line times the registration forward (``VxmDense``, ``int_steps`` 5,
``svf_res`` = ``int_res`` = 2, bf16) at 192³, batch 1: one warm-up forward,
whose kernel launches, by kernel and by C entry, must be
``VxmDense.kernel_launches()``, then ``--blocks`` blocks of ``--iters`` chained
forwards (each forward's moved image is the next one's moving image), each
block timed with CUDA events; the best block is reported. The timed blocks
must launch the same kernels again, every forward: a forward that fell back
to a plain version fails the run. ``vs_baseline`` divides by the TF-CPU
numbers in the tracked ``.bench_baseline.json``, which this script only
reads.

    python bench_torch.py                       # the three lines, on the GPU
    python bench_torch.py --arch train64        # one line
    python bench_torch.py --arch infer256 --quantize int8
    python bench_torch.py --device cpu          # plain versions on the CPU (slow at 192³)

Without a GPU and without ``--device cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multimodal_registration_torch import kernels
from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.quantize import calibrate_scales, load_scales
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.train.trainer import init_like_flax_

SHAPE = (192, 192, 192)
BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_baseline.json")

# headline architectures: the reference's TRAINING widths (config/config.json:
# 44-45) and its published INFERENCE widths (config/config_inference.json:8-9)
ARCHS = {
    "train64": dict(
        enc=(64,) * 4, dec=(64,) * 6,
        metric="registered_192cube_vol_pairs_per_sec",
        baseline_key="tf_cpu_pairs_per_sec_192",
    ),
    "infer256": dict(
        enc=(256,) * 4, dec=(256,) * 6,
        metric="registered_192cube_enc256_pairs_per_sec",
        baseline_key="tf_cpu_pairs_per_sec_192_enc256",
    ),
}

W256_CKPT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "benchmarks", "learned_w256_160x160x192_26lab.npz",
)


def _load_w256(cfg: VxmConfig):
    """The trained published-widths checkpoint and its int8 sidecar, when
    present: ``(state dict, scales, note)``; ``(None, None, note)`` without
    the checkpoint."""
    if not os.path.exists(W256_CKPT):
        return None, None, "random-init params (w256 checkpoint not found)"
    with np.load(W256_CKPT) as z:
        params = params_from_jax(dict(z), cfg)
    scales = None
    note = "trained w256 checkpoint"
    sidecar = W256_CKPT + ".quant.json"
    if os.path.exists(sidecar):
        scales = load_scales(sidecar)
        note += " + quant sidecar"
    return params, scales, note


def _timed_seconds(dev: torch.device, fn) -> float:
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


def model_config(arch: str, quantize: str = "") -> VxmConfig:
    """The benchmarked model of ``ARCHS[arch]``."""
    a = ARCHS[arch]
    return VxmConfig(enc=a["enc"], dec=a["dec"], int_steps=5, int_res=2, svf_res=2,
                     compute_dtype="bfloat16", quantize=quantize)


def bench_model(arch: str, quantize: str = "", shape=SHAPE, batch: int = 1,
                device=None) -> VxmDense:
    """The benchmarked model on ``device``, in eval mode: infer256 on the
    trained w256 checkpoint and its int8 sidecar when present, else (and for
    train64) a random init from seed 0; int8 without a sidecar calibrates on
    ``bench.py``'s synthetic input of ``(batch, *shape)``."""
    dev = resolve_device(device)
    cfg = model_config(arch, quantize)
    model = VxmDense(cfg, device=dev).eval()
    params, scales = None, None
    if arch == "infer256":
        params, scales, note = _load_w256(cfg)
        print(f"# infer256 weights: {note}", file=sys.stderr)
    if params is None:
        init_like_flax_(model, 0)
    else:
        model.load_state_dict(params)
    if quantize:
        if scales is None:
            # one full-precision calibration forward on synthetic inputs; the
            # scale values change the numerics, not the speed
            n = batch * math.prod(shape)
            calib = torch.linspace(0, 1, n, device=dev).reshape(batch, *shape, 1)
            scales = calibrate_scales(cfg, model, [(calib, 1 - calib)])
        model.set_quant_scales(scales)
    return model


def measure(shape=SHAPE, iters=10, batch=1, arch="train64", blocks=3, quantize="",
            device=None):
    """Pairs per second of the forward of ``ARCHS[arch]`` at ``shape``: the
    best of ``blocks`` blocks of ``iters`` chained forwards of ``batch``
    pairs. Runs on the GPU unless ``device`` says otherwise; on the GPU a
    forward that does not launch the kernels raises."""
    dev = resolve_device(device)
    print(f"# {arch}{' ' + quantize if quantize else ''}: {tuple(shape)}, batch {batch} on {dev}",
          file=sys.stderr)
    model = bench_model(arch, quantize, shape, batch, dev)
    want = model.kernel_launches()
    mov = torch.zeros((batch, *shape, 1), dtype=torch.float32, device=dev)
    fx = torch.ones((batch, *shape, 1), dtype=torch.float32, device=dev)

    def forward(m):
        out = model(m, fx)
        return out["moved"], out["warp"]

    best = None
    with torch.inference_mode():
        kernels.reset_launch_counts()
        forward(mov)  # warm-up
        per_forward = kernels.launch_counts()
        print(f"# launches per forward: {json.dumps(per_forward)}", file=sys.stderr)
        if dev.type == "cuda":
            if {**per_forward, **kernels.entry_launch_counts()} != want:
                raise RuntimeError(f"the forward launched {per_forward}, want {want}")
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)

        def block():
            x = mov
            for _ in range(iters):
                x, _ = forward(x)

        for b in range(blocks):
            dt = _timed_seconds(dev, block) / iters
            print(f"# block {b}: {dt * 1000:.1f} ms/iter", file=sys.stderr)
            best = dt if best is None else min(best, dt)
    total = kernels.launch_counts()
    print(f"# launches in all: {json.dumps(total)}", file=sys.stderr)
    if dev.type == "cuda":
        n = 1 + blocks * iters
        if {**total, **kernels.entry_launch_counts()} != {k: v * n for k, v in want.items()}:
            raise RuntimeError(f"the timed forwards launched {total}, want {n} x {want}")
        print(f"# best {best * 1000:.4f} ms/forward, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB", file=sys.stderr)
    return batch / best


def get_baseline(arch="train64"):
    """``arch``'s tracked TF-CPU pairs/s from ``.bench_baseline.json``, which
    is only read; None when it has none."""
    if not os.path.exists(BASELINE_CACHE):
        return None
    with open(BASELINE_CACHE) as f:
        return json.load(f).get(ARCHS[arch]["baseline_key"])


def vs_baseline(value: float, arch: str) -> float:
    """``value`` over ``arch``'s tracked baseline; 1.0 when there is none."""
    base = get_baseline(arch)
    if not base:
        print(f"# no {ARCHS[arch]['baseline_key']} in {os.path.basename(BASELINE_CACHE)}: "
              "vs_baseline 1.0", file=sys.stderr)
        return 1.0
    return value / base


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1, help="pairs per forward")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--blocks", type=int, default=3,
                    help="independent timing blocks; the best is reported")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS),
                    help="measure ONE architecture: train64 = flagship training widths; "
                         "infer256 = the published inference widths. Default (no flag): "
                         "all three metrics, infer256 bf16, infer256 int8, then train64 LAST")
    ap.add_argument("--quantize", default="", choices=["", "int8"],
                    help="int8 = quantized inference (the wide convs on kernel K8); "
                         "only with --arch")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; the CPU only when asked for")
    return ap


def _print_device(dev: torch.device) -> None:
    if dev.type != "cuda":
        print(f"# device {dev}: the plain versions on the host, no device metric",
              file=sys.stderr)
        return
    print(f"# device {torch.cuda.get_device_name(dev)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", file=sys.stderr)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        for line in smi.stdout.strip().splitlines():
            print(f"# {line}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    _print_device(dev)
    if args.arch is None:
        # the three metrics, the headline last so that a tail capture reads train64
        specs = [("infer256", ""), ("infer256", "int8"), ("train64", "")]
    else:
        specs = [(args.arch, args.quantize)]
    for arch, quantize in specs:
        value = measure(SHAPE, iters=args.iters, batch=args.batch, arch=arch,
                        blocks=args.blocks, quantize=quantize, device=dev)
        metric = ARCHS[arch]["metric"]
        if quantize:
            metric += f"_{quantize}"
        print(json.dumps({"metric": metric, "value": round(value, 4), "unit": "pairs/s",
                          "vs_baseline": round(vs_baseline(value, arch), 2)}), flush=True)
        sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
