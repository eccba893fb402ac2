"""U-Net backward attribution: which adjoint makes the conv stack's backward costly.

    python -m multimodal_registration_torch.tools.unet_bwd_probe [iters] [--small]
        [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/unet_bwd_probe.py``. Each section is
timed forward-only and forward with its gradient at the reference workload
(160x160x192, enc [64]x4 / dec [64]x6, bf16; ``--small``: 32x32x48); the
difference is its backward. The gradient is taken w.r.t. the parameters only,
as JAX's ``value_and_grad`` of ``params`` is: the input needs none. The
forward-only call records the autograd graph, as the forward of a step does,
and drops it.

* ``unet_full``: the whole ``Unet(nb_upsample_skips=1)``. Under gradients its
  enc_0 is cuDNN's conv + ``max_pool_2x`` (K1 is inference-only), as in the
  trainer: four pools, so four launches of K4 a forward and backward;
* ``first_conv``: the 2->64 conv + LeakyReLU alone (:class:`ConvLeaky`, bf16
  compute on float32 parameters, as ``nn.Conv(dtype=bf16,
  param_dtype=f32)``);
* ``first_convpool``: + ``F.max_pool3d``, the JAX ``nn.max_pool`` (XLA's
  adjoint): the yardstick whose backward K4 replaced;
* ``first_convrpool``: + ``ops/pool.py::max_pool_2x``, whose backward is K4;
* ``enc_rest``: encoder levels 2..4 (three conv + pool levels on a half-res
  64-channel input).

Keys ``<section>_fwd_ms``, ``_fwd_bwd_ms`` and ``_bwd_ms`` (rounded to 0.1
ms, as the JAX script rounds), one JSON line a section, then the whole record.
The JAX probe caught every failure of a section into ``<section>_error`` (its
remote compiler's request-size failure); the port catches nothing: a failing
section raises and the tool exits non-zero. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.unet import Unet
from multimodal_registration_torch.ops.pool import max_pool_2x
from multimodal_registration_torch.tools.timing import card_note, ms_per_call, note, write_result

SECTIONS = ("unet_full", "first_conv", "first_convpool", "first_convrpool", "enc_rest")
POOLS = ("none", "xla", "reshape")


class ConvLeaky(nn.Module):
    """3^3 SAME convs + LeakyReLU(0.2), each followed by a pool: ``none``,
    ``xla`` (``F.max_pool3d``) or ``reshape`` (``ops/pool.py::max_pool_2x``).
    Channels-last ``(B, X, Y, Z, C)``; bf16 compute on float32 parameters."""

    def __init__(self, cin: int, feats=(64,), pool: str = "none", device=None):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be one of {POOLS}, got {pool!r}")
        self.pool = pool
        self.convs = nn.ModuleList()
        for f in feats:
            self.convs.append(nn.Conv3d(cin, f, 3, padding=1, device=device))
            cin = f

    def forward(self, x):
        x = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        for conv in self.convs:
            x = F.leaky_relu(F.conv3d(x, conv.weight.to(torch.bfloat16),
                                      conv.bias.to(torch.bfloat16), padding=1), 0.2)
            if self.pool == "xla":
                x = F.max_pool3d(x, 2, 2)
            elif self.pool == "reshape":
                x = max_pool_2x(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
        return x.permute(0, 2, 3, 4, 1)


def fwd_vs_bwd(dev, name, model, x, res, iters, emit=print) -> None:
    """Time ``sum(model(x))`` and its gradient w.r.t. the parameters."""
    params = list(model.parameters())

    def scalar():
        return model(x).float().sum()

    def grad():
        return torch.autograd.grad(scalar(), params)

    res[f"{name}_fwd_ms"] = round(ms_per_call(dev, scalar, iters), 1)
    res[f"{name}_fwd_bwd_ms"] = round(ms_per_call(dev, grad, iters), 1)
    res[f"{name}_bwd_ms"] = round(res[f"{name}_fwd_bwd_ms"] - res[f"{name}_fwd_ms"], 1)
    emit(json.dumps({k: res[k] for k in res if k.startswith(name)}))


def run(iters: int = 6, small: bool = False, device=None, emit=print) -> dict:
    dev = resolve_device(device)
    shape = (32, 32, 48) if small else (160, 160, 192)
    rng = np.random.default_rng(0)
    res = {"shape": list(shape)}
    x2 = torch.as_tensor(rng.normal(size=(1, *shape, 2)).astype(np.float32), device=dev)
    torch.manual_seed(0)
    fwd_vs_bwd(dev, "unet_full",
               Unet(2, (64,) * 4, (64,) * 6, nb_upsample_skips=1, device=dev),
               x2, res, iters, emit)
    fwd_vs_bwd(dev, "first_conv", ConvLeaky(2, (64,), device=dev), x2, res, iters, emit)
    fwd_vs_bwd(dev, "first_convpool", ConvLeaky(2, (64,), "xla", device=dev), x2, res, iters,
               emit)
    fwd_vs_bwd(dev, "first_convrpool", ConvLeaky(2, (64,), "reshape", device=dev), x2, res,
               iters, emit)
    half = tuple(s // 2 for s in shape)
    xh = torch.as_tensor(rng.normal(size=(1, *half, 64)).astype(np.float32), device=dev)
    fwd_vs_bwd(dev, "enc_rest", ConvLeaky(64, (64, 64, 64), "reshape", device=dev), xh, res,
               iters, emit)
    emit(json.dumps(res))
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", nargs="?", type=int, default=6)
    ap.add_argument("--small", action="store_true", help="32x32x48")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    res = run(a.iters, a.small, dev)
    write_result(a.out, res)
    return res


if __name__ == "__main__":
    main()
