"""Backward-pass attribution at the reference training workload.

    python -m multimodal_registration_torch.tools.bwd_breakdown [iters] [--small]
        [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/bwd_breakdown.py``. Each component of
the training step at its in-training shape (160x160x192, 26 labels, int res
2) is timed forward-only and forward with its gradient; the difference is
its backward. The forward-only call records the autograd graph, as the
step's forward does, and drops it, so the difference is the backward alone.

* ``model``: the flagship ``VxmDense`` (a random init from seed 0) on two
  1-channel inputs, ``sum(flow_fullres)``, gradient w.r.t. the parameters
  (cuDNN's convs, K4 for the pools, K2/K5 for the integration);
* ``integrate``: scaling and squaring (5 steps, bf16 payload) at 80x80x96x3,
  gradient w.r.t. the SVF (K2's fused step, K5's);
* ``rescale``: the half-res field to full res, gradient w.r.t. the half field;
* ``compose``: ``compose_fields_batch(phi_gen in bf16, flow)``, gradient
  w.r.t. ``flow`` (K2, K5);
* ``onehot``: ``warp_onehot(labels, flow, 26)``, gradient w.r.t. ``flow``
  (K6, K7);
* ``onehot_dice`` (the port's own; the JAX script has no such row): the
  training loss's Dice, ``warp_onehot_dice_batch(labels, flow, t, 26,
  zeropad=True)`` against a soft target, gradient w.r.t. ``flow`` (K6's and
  K7's Dice entries: neither the warped map nor its cotangent is formed);
* ``tail``: Dice (zero-pad) + Grad('l2', 0.02), gradient w.r.t. both inputs.

Keys ``<component>_fwd_ms``, ``_fwd_bwd_ms``, ``_bwd_ms``; one JSON line a
component, then the whole record. The JAX script's ``tail_error`` (its
remote compiler's request-size failure) has no counterpart. ``--small``:
32x32x48, 8 labels. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodal_registration_torch.device import full_fp32_convs, resolve_device
from multimodal_registration_torch.losses import dice_loss_zeropad, grad_loss
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.ops.field import compose_fields_batch
from multimodal_registration_torch.ops.integrate import integrate_svf
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_onehot, warp_onehot_dice_batch
from multimodal_registration_torch.tools.timing import card_note, ms_per_call, note, write_result
from multimodal_registration_torch.train.trainer import init_like_flax_

COMPONENTS = ("model", "integrate", "rescale", "compose", "onehot", "onehot_dice", "tail")


def _gradient(scalar_fn, leaves):
    """A call of ``scalar_fn(*leaves)`` and its gradient w.r.t. ``leaves``."""
    def call():
        s = scalar_fn(*leaves)
        with full_fp32_convs():
            return torch.autograd.grad(s, leaves)
    return call


def run(iters: int = 8, small: bool = False, device=None, emit=print) -> dict:
    """Measure each component; ``emit`` gets one JSON line a component."""
    dev = resolve_device(device)
    shape = (32, 32, 48) if small else (160, 160, 192)
    L = 8 if small else 26
    r = 2
    half = tuple(s // r for s in shape)
    rng = np.random.default_rng(0)
    res = {"shape": list(shape)}

    def t(arr):
        return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float32), device=dev)

    def leaf(x):
        return x.detach().clone().requires_grad_()

    def component(name, fwd, fwd_bwd):
        res[f"{name}_fwd_ms"] = ms_per_call(dev, fwd, iters)
        res[f"{name}_fwd_bwd_ms"] = ms_per_call(dev, fwd_bwd, iters)
        res[f"{name}_bwd_ms"] = res[f"{name}_fwd_bwd_ms"] - res[f"{name}_fwd_ms"]
        emit(json.dumps({k: res[k] for k in list(res)[-3:]}))

    model = VxmDense(VxmConfig(), device=dev)
    init_like_flax_(model, 0)
    m, f = t(rng.normal(size=(1, *shape, 1))), t(rng.normal(size=(1, *shape, 1)))
    params = list(model.parameters())

    def model_scalar(*_):
        return model(m, f, with_moved=False)["flow_fullres"].float().sum()

    component("model", model_scalar, _gradient(model_scalar, params))

    svf = leaf(t(rng.normal(size=(*half, 3))) * 2.0)

    def integ_scalar(v):
        return integrate_svf(v, 5, payload_dtype=torch.bfloat16).float().sum()

    component("integrate", lambda: integ_scalar(svf), _gradient(integ_scalar, [svf]))

    phi_half = leaf(t(rng.normal(size=(*half, 3))))

    def rescale_scalar(v):
        return rescale_field(v, float(r), out_shape=shape).sum()

    component("rescale", lambda: rescale_scalar(phi_half), _gradient(rescale_scalar, [phi_half]))

    phi = t(rng.normal(size=(1, *shape, 3)) * 3).bfloat16()
    flow = leaf(t(rng.normal(size=(1, *shape, 3)) * 2))

    def compose_scalar(fl):
        return compose_fields_batch(phi, fl).float().sum()

    component("compose", lambda: compose_scalar(flow), _gradient(compose_scalar, [flow]))

    lab = torch.as_tensor(rng.integers(0, L, size=shape, dtype=np.int32), device=dev)
    flow1 = leaf(flow[0])

    def onehot_scalar(fl):
        return warp_onehot(lab, fl, L).sum()

    component("onehot", lambda: onehot_scalar(flow1), _gradient(onehot_scalar, [flow1]))

    # the training loss's Dice as the step takes it: fused, against the soft
    # warp of the same labels by half the field
    with torch.no_grad():
        tmap = warp_onehot(lab, flow1 * 0.5, L)[None]

    def onehot_dice_scalar(fl):
        return warp_onehot_dice_batch(lab[None], fl[None], tmap, L, zeropad=True)

    component("onehot_dice", lambda: onehot_dice_scalar(flow1),
              _gradient(onehot_dice_scalar, [flow1]))
    del tmap

    a = t(np.abs(rng.normal(size=(1, *shape, L))))
    b = leaf(t(np.abs(rng.normal(size=(1, *shape, L)))))
    fl = leaf(flow)

    def tail_scalar(pred, field):
        return dice_loss_zeropad(a, pred) + grad_loss(field, "l2", 0.02)

    component("tail", lambda: tail_scalar(b, fl), _gradient(tail_scalar, [b, fl]))
    emit(json.dumps(res))
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", nargs="?", type=int, default=8)
    ap.add_argument("--small", action="store_true", help="32x32x48 / 8 labels")
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
