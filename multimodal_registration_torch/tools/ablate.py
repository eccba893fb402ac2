"""Component-level performance ablation of the flagship forward on the card.

    python -m multimodal_registration_torch.tools.ablate [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/ablate.py``. Times the forward's pieces
separately at ``shape`` 192^3, each as a chain of calls in which every call's
output feeds the next one (one warm-up call, then ``iters`` chained calls,
timed with :func:`tools.timing.elapsed_s`: CUDA events on the card):

* ``unet_convs_ms``: ``Unet(enc [64]x4, dec [64]x6, nb_upsample_skips=1,
  bf16)`` without gradients, so enc_0 is kernel K1 (``models/unet.py``:
  ``fused_first`` holds when nothing needs a gradient), its half-res features
  repeated back to the full grid and folded to two channels, as the JAX
  chain does;
* ``integrate5_halfres_ms``: ``integrate_svf(v, 5)`` at half res, five
  launches of K2's fused squaring step;
* ``warp_fullres_ms``: ``warp(f, f)``, a 3-channel full-res field warped by
  itself (K2's general entry);
* ``rescale_2x_ms``: ``rescale_field(rescale_field(v, 2), 0.5)`` (no kernel,
  ``ops/resize.py``).

One JSON line, ``{"shape": [...], <rows rounded to 2 places>}``, as the JAX
script prints. The U-Net's weights are PyTorch's default initialisation from
seed 0. ``main(shape=...)`` is a function argument (the CPU tests' small
shape), not a flag. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.unet import Unet
from multimodal_registration_torch.ops.integrate import integrate_svf
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp
from multimodal_registration_torch.tools.timing import card_note, elapsed_s, note, write_result

ROWS = ("unet_convs_ms", "integrate5_halfres_ms", "warp_fullres_ms", "rescale_2x_ms")
SHAPE = (192, 192, 192)
ITERS = 8


def chains(shape=SHAPE, device=None) -> dict:
    """``{row: (fn, x0)}``: each chain's call and its first input."""
    dev = resolve_device(device)
    half = tuple(s // 2 for s in shape)
    torch.manual_seed(0)
    unet = Unet(2, (64,) * 4, (64,) * 6, nb_upsample_skips=1, dtype=torch.bfloat16,
                device=dev).eval()

    def unet_fn(x):
        feat = unet(x)  # (1, *half, 64)
        up = feat.repeat_interleave(2, 1).repeat_interleave(2, 2).repeat_interleave(2, 3)
        return torch.cat([up[..., :1], up[..., 1:2]], -1) + x * 0.0 + up[..., :2]

    v0 = torch.zeros((*half, 3), device=dev)
    return {
        "unet_convs_ms": (unet_fn, torch.zeros((1, *shape, 2), dtype=torch.bfloat16, device=dev)),
        "integrate5_halfres_ms": (lambda v: integrate_svf(v, 5), v0),
        "warp_fullres_ms": (lambda f: warp(f, f), torch.zeros((*shape, 3), device=dev)),
        "rescale_2x_ms": (lambda v: rescale_field(rescale_field(v, 2.0), 0.5), v0),
    }


@torch.inference_mode()
def timed_chain(dev: torch.device, fn, x, iters: int = ITERS) -> float:
    """Seconds a call of a chain ``x -> fn(x) -> fn(fn(x)) ...``."""
    fn(x)  # warm-up

    def chain():
        cur = x
        for _ in range(iters):
            cur = fn(cur)

    return elapsed_s(dev, chain) / iters


def run(shape=SHAPE, device=None, emit=print) -> dict:
    dev = resolve_device(device)
    results = {row: timed_chain(dev, fn, x) * 1000 for row, (fn, x) in chains(shape, dev).items()}
    res = {"shape": list(shape), **{k: round(v, 2) for k, v in results.items()}}
    emit(json.dumps(res))
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None, shape=SHAPE) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    res = run(shape, dev)
    write_result(a.out, res)
    return res


if __name__ == "__main__":
    main()
