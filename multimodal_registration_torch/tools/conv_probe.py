"""Per-level 3-D conv efficiency probe for the flagship U-Net at 192^3, on cuDNN.

    python -m multimodal_registration_torch.tools.conv_probe [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/conv_probe.py``. Times the seven conv
layers of :data:`CASES` (the JAX script's labels, shapes, channels and
strides) in bf16 and reports the achieved TFLOP/s against the H100's dense
bf16 tensor-core peak of 989 TFLOP/s (:data:`PEAK_TFLOPS`), to show which U-Net
levels leave the tensor cores idle.

Each case is called as the port's U-Net calls a conv (``models/unet.py``,
``ConvBlock.forward``): ``F.conv3d`` (cuDNN) on the NCDHW view of a
channels-last ``(1, X, Y, Z, Cin)`` bf16 tensor (the U-Net's activations are
bf16), bf16 weights and bias, ``padding=1``; the bias is added, no
activation, as the JAX script's ``nn.Conv``. Stride 2 pads as flax's
``SAME`` does, low ``(k - 1 - (n - 1) % s) // 2`` and the rest high ((0, 1)
on an even size, where PyTorch's ``padding=1`` would pad (1, 1)), through
``F.pad`` (:func:`conv`). The port's U-Net pools and never strides; the case
stays as the JAX script's. The input is ones and the weights a seeded normal
draw: the values do not change the work.

A case's time is :func:`tools.timing.ms_per_call` (CUDA events; two warm-up
calls, for cuDNN's choice of algorithm, then the best of 3 blocks of 8 calls
back to back). Its FLOPs are the JAX script's ``out_vox * 27 * cin * cout *
2``. One JSON line a case, ``{"case", "ms", "tflops"}``, rounded to 2 places
as there; ``--out`` writes the list of them. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.unet import _ncdhw, _ndhwc
from multimodal_registration_torch.tools.timing import card_note, ms_per_call, note, write_result

# (label, shape, cin, cout, stride), benchmarks/conv_probe.py's cases
CASES = (
    ("enc0_full", (192, 192, 192), 2, 64, 1),
    ("enc0_stride2", (192, 192, 192), 2, 64, 2),
    ("enc1_96", (96, 96, 96), 64, 64, 1),
    ("enc2_48", (48, 48, 48), 64, 64, 1),
    ("dec_96_concat", (96, 96, 96), 128, 64, 1),
    ("final_96", (96, 96, 96), 64, 64, 1),
    ("wide_96_128ch", (96, 96, 96), 128, 128, 1),
)
PEAK_TFLOPS = 989.0  # H100 SXM dense bf16 tensor cores
ITERS, WARMUP, BLOCKS = 8, 2, 3


def same_pads(size: int, stride: int, k: int = 3) -> tuple:
    """flax's ``SAME`` padding (low, high) of one dimension."""
    total = max(k - 1 - (size - 1) % stride, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The 3^3 SAME conv of channels-last ``x`` ``(B, X, Y, Z, Cin)`` with
    ``w`` ``(Cout, Cin, 3, 3, 3)`` and ``b``, channels-last out; the U-Net's
    call for stride 1, flax's ``SAME`` padding for any stride."""
    xc = _ncdhw(x)
    if stride == 1:
        return _ndhwc(F.conv3d(xc, w, b, padding=1))
    pads = [p for n in reversed(x.shape[1:4]) for p in same_pads(n, stride)]
    return _ndhwc(F.conv3d(F.pad(xc, pads), w, b, stride=stride))


def flops(shape, cin: int, cout: int, stride: int) -> int:
    return math.prod(s // stride for s in shape) * 27 * cin * cout * 2


def time_conv(shape, cin: int, cout: int, stride: int, device) -> float:
    """Seconds a call of the case's conv in bf16."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=gen) / math.sqrt(27 * cin)).to(
        dev, torch.bfloat16)
    b = torch.zeros(cout, dtype=torch.bfloat16, device=dev)
    x = torch.ones((1, *shape, cin), dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        ms = ms_per_call(dev, lambda: conv(x, w, b, stride), ITERS, WARMUP, BLOCKS)
    return ms / 1e3


def run(device=None, emit=print, cases=CASES) -> list:
    """One row a case, ``{"case", "ms", "tflops"}`` rounded as the JAX
    script; each returned row also carries ``seconds`` and ``flops``."""
    dev = resolve_device(device)
    rows = []
    for label, shape, cin, cout, stride in cases:
        dt = time_conv(shape, cin, cout, stride, dev)
        n = flops(shape, cin, cout, stride)
        row = {"case": label, "ms": round(dt * 1000, 2), "tflops": round(n / dt / 1e12, 2)}
        emit(json.dumps(row))
        rows.append(dict(row, seconds=dt, flops=n))
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    return ap


def main(argv=None) -> list:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    rows = run(dev)
    write_result(a.out, [{k: r[k] for k in ("case", "ms", "tflops")} for r in rows])
    return rows


if __name__ == "__main__":
    main()
