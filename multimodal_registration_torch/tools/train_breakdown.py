"""Training-step time attribution at the reference workload (160x160x192, 26 labels).

    python -m multimodal_registration_torch.tools.train_breakdown [iters] [--small]
        [--svf2|--svf4] [--grad2] [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/train_breakdown.py``. Times nested
prefixes of the real step, built from the trainer's own pieces, each chained
``iters`` times on one ``torch.Generator`` after one warm-up call:

* ``synth_ms``: :func:`draw_batch` + :func:`build_batch` (flips, zero
  borders, the two syntheses);
* ``model_fwd_ms``: + ``VxmDense.forward`` as the loss calls it (no ``moved``,
  whose kernel K3 has no backward, and which the loss does not read), summed;
* ``model_fwd_bwd_ms``: + that sum's backward;
* ``fwd_ms``: synthesis + :func:`loss_from_batch` (the model, the compose,
  the label warp, Dice + Grad);
* ``fwd_bwd_ms``: + its backward;
* ``full_step_ms``: :meth:`Trainer.train_step` (+ the optional clip and Adam).

The forward rows record the autograd graph, as the step's forward does, and
drop it. Derived (``train_breakdown.py:158-163``): ``bwd_attributed_ms`` =
``fwd_bwd - fwd``, ``loss_fwd_attributed_ms`` = ``fwd - synth``,
``model_bwd_ms`` = ``model_fwd_bwd - model_fwd``, ``loss_tail_bwd_ms`` =
``bwd_attributed - model_bwd``. One JSON line a row as it is measured, then
the whole record. ``--small``: 32x32x48, 8 labels. ``--svf2``/``--svf4`` set
``svf_int_res``, ``--grad2`` ``grad_res`` 2. The JAX script's ``--zline`` and
``--zline-compose`` select TPU layouts (ROADMAP item 17) and exit with a
message. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodal_registration_torch.device import full_fp32_convs, resolve_device
from multimodal_registration_torch.tools.timing import card_note, ms_per_call, note, write_result
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.train.trainer import (
    Trainer, build_batch, draw_batch, loss_from_batch)

ROWS = ("synth_ms", "model_fwd_ms", "model_fwd_bwd_ms", "fwd_ms", "fwd_bwd_ms", "full_step_ms")
DERIVED = ("bwd_attributed_ms", "loss_fwd_attributed_ms", "model_bwd_ms", "loss_tail_bwd_ms")
ITEM17 = ("--zline", "--zline-compose")


def derive(res: dict) -> dict:
    """The four attributed rows from the six measured ones."""
    out = {"bwd_attributed_ms": res["fwd_bwd_ms"] - res["fwd_ms"],
           "loss_fwd_attributed_ms": res["fwd_ms"] - res["synth_ms"],
           "model_bwd_ms": res["model_fwd_bwd_ms"] - res["model_fwd_ms"]}
    out["loss_tail_bwd_ms"] = out["bwd_attributed_ms"] - out["model_bwd_ms"]
    return out


def breakdown_config(small: bool = False, svf_int_res: int | None = None,
                     grad_res: int | None = None, width: int = 0) -> TrainConfig:
    shape = [32, 32, 48] if small else [160, 160, 192]
    over = {} if svf_int_res is None else {"svf_int_res": svf_int_res}
    if grad_res is not None:
        over["grad_res"] = grad_res
    if width:
        over.update(enc=[width] * 4, dec=[width] * 6)
    return TrainConfig.from_dict(dict(in_shape=shape, num_labels=8 if small else 26,
                                      batch_size=1, zero_borders_maps=True, epochs=1,
                                      **over))


def run(iters: int = 6, small: bool = False, svf_int_res: int | None = None,
        grad_res: int | None = None, device=None, emit=print, width: int = 0) -> dict:
    """Measure the rows; ``emit`` gets one JSON line a row as it is taken.
    ``width`` (not a flag of the JAX script) sets enc/dec to ``[width] * 4``
    / ``[width] * 6``, as ``train_bench --width`` does."""
    dev = resolve_device(device)
    cfg = breakdown_config(small, svf_int_res, grad_res, width)
    trainer = Trainer(cfg, device=dev)
    model, ecfg = trainer.model, trainer.engine_cfg
    rng = np.random.default_rng(0)
    shape = tuple(cfg.in_shape)
    src = torch.as_tensor(rng.integers(0, cfg.num_labels, size=(1, *shape), dtype=np.uint8),
                          device=dev)
    trg = torch.as_tensor(rng.integers(0, cfg.num_labels, size=(1, *shape), dtype=np.uint8),
                          device=dev)
    gen = trainer.generator(0)
    zb = cfg.zero_borders_maps
    use_zeropad = cfg.zero_borders_maps or cfg.zero_borders_maps_val

    def synth():
        return build_batch(draw_batch(gen, src, trg, ecfg, cfg, zb), ecfg)

    def model_sum():
        b = synth()
        out = model(b["img1"][..., None], b["img2"][..., None], with_moved=False,
                    pool_tie=trainer.pool_tie)
        return out["warp"].float().sum() + out["flow_fullres"].float().sum()

    def backward(s):
        model.zero_grad(set_to_none=True)
        with full_fp32_convs():
            s.backward()

    def loss():
        return loss_from_batch(model, synth(), ecfg, cfg, use_zeropad,
                               pool_tie=trainer.pool_tie)[0]

    model.train()
    prefixes = {
        "synth_ms": synth,
        "model_fwd_ms": model_sum,
        "model_fwd_bwd_ms": lambda: backward(model_sum()),
        "fwd_ms": loss,
        "fwd_bwd_ms": lambda: backward(loss()),
        "full_step_ms": lambda: trainer.train_step(gen, src, trg),
    }
    res = {"zline": False, "zline_compose": False,
           "svf_int_res": cfg.svf_int_res, "grad_res": cfg.grad_res}
    for name, fn in prefixes.items():
        res[name] = ms_per_call(dev, fn, iters)
        emit(json.dumps({name: res[name]}))
    res.update(derive(res))
    emit(json.dumps(res))
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", nargs="?", type=int, default=6)
    ap.add_argument("--small", action="store_true", help="32x32x48 / 8 labels")
    svf = ap.add_mutually_exclusive_group()
    svf.add_argument("--svf2", dest="svf_int_res", action="store_const", const=2)
    svf.add_argument("--svf4", dest="svf_int_res", action="store_const", const=4)
    ap.add_argument("--grad2", dest="grad_res", action="store_const", const=2,
                    help="grad_res 2 (the smoothness penalty on the int-res warp)")
    for flag in ITEM17:
        ap.add_argument(flag, action="store_true", help="a TPU layout: not in the port")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    if a.zline or a.zline_compose:
        raise SystemExit(f"{' / '.join(ITEM17)}: TPU layout switches (ROADMAP item 17, "
                         "kept out of the port)")
    dev = resolve_device(a.device)
    note(card_note(dev))
    res = run(a.iters, a.small, a.svf_int_res, a.grad_res, dev)
    write_result(a.out, res)
    return res


if __name__ == "__main__":
    main()
