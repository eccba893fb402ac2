"""Forward decomposition of the registration model at 192^3.

    python -m multimodal_registration_torch.tools.fwd_breakdown [--arch train|infer256]
        [--iters N] [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/fwd_breakdown.py``. Times nested
prefixes of the real ``VxmDense`` forward at (1, 192, 192, 192, 1), batch 1,
in inference mode, built from its own pieces (``models/vxm_dense.py``):

* ``upto_svf_ms``: the U-Net (enc_0 on K1) and the float32 flow head;
* ``upto_warp_ms``: + :meth:`VxmDense.tail` without ``moved`` or
  ``flow_fullres``: the integration (K2's fused step x5);
* ``upto_flow_fullres_ms``: + the full-res field (``with_fullres``);
* ``upto_moved_ms``: the integration and the moved image (K3, which reads
  the half-res field; ``with_moved``), no full-res field;
* ``full_predict_ms``: ``forward`` with ``moved`` and ``warp``, as the JAX
  script's full predict reads them.

``--arch train`` (default): the flagship training widths (enc [64]x4 / dec
[64]x6) from a random init (seed 0); ``--arch infer256``: the published
inference widths (enc/dec 256) on ``benchmarks/learned_w256_…npz`` through
``params_from_jax``, as ``bench_torch.py`` loads it. Each row: one warm-up
forward, then ``--iters`` forwards back to back (default 8 for train, 3 for
infer256) between two CUDA events; the moving image is zeros and the fixed
ones, as ``bench_torch.py``'s. One JSON line a row, then the whole record.
Differences of consecutive rows attribute the forward. Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.tools.timing import (
    BENCHMARKS, card_note, ms_per_call, note, write_result)
from multimodal_registration_torch.train.trainer import init_like_flax_

W256_CKPT = os.path.join(BENCHMARKS, "learned_w256_160x160x192_26lab.npz")
ROWS = ("upto_svf_ms", "upto_warp_ms", "upto_flow_fullres_ms", "upto_moved_ms",
        "full_predict_ms")


def arch_model(arch: str, device) -> VxmDense:
    """The model of ``--arch``, in eval mode on ``device``."""
    width = 64 if arch == "train" else 256
    cfg = VxmConfig(enc=(width,) * 4, dec=(width,) * 6, int_steps=5, int_res=2, svf_res=2,
                    compute_dtype="bfloat16")
    model = VxmDense(cfg, device=device).eval()
    if arch == "train":
        init_like_flax_(model, 0)
    else:
        with np.load(W256_CKPT) as z:
            model.load_state_dict(params_from_jax(dict(z), cfg))
    return model


def prefixes(model: VxmDense, mov: torch.Tensor, fx: torch.Tensor) -> dict:
    """``{row: call}`` of the nested forwards."""
    def svf():
        return model.flow_head(model.unet(torch.cat([mov, fx], dim=-1)))

    def tail(**kw):
        return lambda: model.tail(mov, svf(), **kw)

    return {
        "upto_svf_ms": svf,
        "upto_warp_ms": tail(with_moved=False, with_fullres=False),
        "upto_flow_fullres_ms": tail(with_moved=False, with_fullres=True),
        "upto_moved_ms": tail(with_moved=True, with_fullres=False),
        "full_predict_ms": lambda: model(mov, fx, with_fullres=False),
    }


@torch.inference_mode()
def run(arch: str = "train", iters: int = 0, shape=(192, 192, 192), device=None,
        emit=print) -> dict:
    dev = resolve_device(device)
    iters = iters or (8 if arch == "train" else 3)
    model = arch_model(arch, dev)
    mov = torch.zeros((1, *shape, 1), dtype=torch.float32, device=dev)
    fx = torch.ones_like(mov)
    results = {}
    for name, fn in prefixes(model, mov, fx).items():
        results[name] = ms_per_call(dev, fn, iters)
        if name != "full_predict_ms":
            emit(json.dumps({name: results[name]}))
    emit(json.dumps(results))
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=("train", "infer256"), default="train")
    ap.add_argument("--iters", type=int, default=0, help="0 = per-arch default")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    res = run(a.arch, a.iters, device=dev)
    write_result(a.out, res)
    return res


if __name__ == "__main__":
    main()
