"""Two-pair pipelining probe for the flagship forward: does a second pair's U-Net fill the gaps of the first's tail?

    python -m multimodal_registration_torch.tools.pair_interleave_probe [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/pair_interleave_probe.py``. The
flagship forward (``VxmDense``, enc [64]x4, dec [64]x6, ``int_steps`` 5,
``svf_res`` = ``int_res`` = 2, bf16) at 192^3 is two stages:

* "U": ``model.unet`` and ``model.flow_head``, the convs (K1, cuDNN, the
  float32 head), the tensor-core phase;
* "T": ``model.tail``, the gathers: the integration (K2's fused step x5) and
  the moved image (K3, ``warp_up2x_batch``).

``VxmDense.forward`` is exactly ``tail(moving, flow_head(unet(cat)))``
(``models/vxm_dense.py``), so the stages are the model's own, not a replica.
The honesty guard (:func:`guard`) holds ``T(U(...))`` against ``model(...)``
at 64^3 within atol 1e-4 before anything is timed.

Five arms, each timed with :func:`tools.timing.ms_per_call` (CUDA events; two
warm-up calls, then the best of 3 blocks of 8 calls back to back):

* ``single_pair_ms``: one pair, U then T;
* ``batch2_ms_per_pair``: both pairs as one batch of 2 through ``model``;
* ``two_seq_ms_per_pair``: pair A whole, then pair B;
* ``two_interleaved_ms_per_pair``: two CUDA streams in place of the JAX
  script's ``optimization_barrier``: stream 1 runs U(A), records an event,
  then T(A); stream 2 waits on that event, then runs U(B) and T(B); so T(A)
  may overlap U(B). The inputs read on a side stream and the outputs handed
  back to the caller's stream are marked with ``record_stream``, so the
  caching allocator does not hand their memory out while a kernel still
  reads it. Each stream keeps its own copy of K1's prepared weights
  (``ops/conv_pool.py``), made in the warm-up calls. On the CPU there are no
  streams: the arm runs its stages in the same order, U(A), T(A), U(B),
  T(B), on the host;
* ``two_free_ms_per_pair``: U(A), U(B), T(A), T(B) on one stream, the JAX
  script's order.

Then ``speedup_interleave_vs_2x_single`` = 2 x single / interleaved (per
call) and ``backend``, the device type. Milliseconds rounded to 1 place and
the speedup to 3, as the JAX script. The weights are initialised as the JAX
script's ``init_params(CFG, inshape=(32, 32, 32), seed=0)`` initialises them
(``train/trainer.py::init_like_flax_``, seed 0); the inputs are
``np.random.default_rng(0)`` draws in [0, 1) in the script's order
(moving A, fixed A, moving B, fixed B, then the guard's pair). Prints the
JAX script's lines; the record goes to ``--out`` only (the JAX script wrote
beside itself; the tools never write under ``benchmarks/``). Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.tools.timing import card_note, ms_per_call, note, write_result
from multimodal_registration_torch.train.trainer import init_like_flax_

SHAPE = (192, 192, 192)
GUARD_SHAPE = (64, 64, 64)
CFG = VxmConfig(enc=(64,) * 4, dec=(64,) * 6, int_steps=5, int_res=2, svf_res=2,
                compute_dtype="bfloat16")
ARMS = ("single_pair_ms", "batch2_ms_per_pair", "two_seq_ms_per_pair",
        "two_interleaved_ms_per_pair", "two_free_ms_per_pair")
GUARD_ATOL = 1e-4
ITERS, WARMUP, BLOCKS = 8, 2, 3


def build(shape=SHAPE, device=None, cfg: VxmConfig = CFG):
    """``(model, (mov_a, fx_a, mov_b, fx_b), rng)``: the model initialised
    from seed 0 and the two pairs ``(1, *shape, 1)``; ``rng`` is left where
    the JAX script's is before its guard."""
    dev = resolve_device(device)
    model = VxmDense(cfg, device=dev)
    init_like_flax_(model, 0)
    model.eval()
    rng = np.random.default_rng(0)
    vols = tuple(torch.as_tensor(rng.random((1, *shape, 1), np.float32), device=dev)
                 for _ in range(4))
    return model, vols, rng


def stage_u(model: VxmDense, mov: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """The U-Net and the flow head: the SVF."""
    return model.flow_head(model.unet(torch.cat([mov, fx], dim=-1)))


def stage_t(model: VxmDense, mov: torch.Tensor, svf: torch.Tensor) -> tuple:
    """The model's tail: ``(moved, warp)``."""
    out = model.tail(mov, svf)
    return out["moved"], out["warp"]


@torch.inference_mode()
def guard(model: VxmDense, rng, device=None, shape=GUARD_SHAPE) -> dict:
    """``T(U(...))`` against ``model(...)`` on a random pair at ``shape``;
    raises when ``moved`` or ``warp`` differ by more than 1e-4. Returns the
    largest differences."""
    dev = resolve_device(device)
    mov = torch.as_tensor(rng.random((1, *shape, 1), np.float32), device=dev)
    fx = torch.as_tensor(rng.random((1, *shape, 1), np.float32), device=dev)
    ref = model(mov, fx)
    moved, warp = stage_t(model, mov, stage_u(model, mov, fx))
    diff = {"moved": float((moved - ref["moved"]).abs().max()),
            "warp": float((warp - ref["warp"]).abs().max())}
    if max(diff.values()) > GUARD_ATOL:
        raise AssertionError(f"the staged tail disagrees with the model: {diff}")
    return diff


def arms(model: VxmDense, vols, device=None) -> dict:
    """``{arm: fn}``; ``fn()`` returns ``[(moved, warp)]`` of each pair it
    computes (one for the single pair, two otherwise)."""
    dev = resolve_device(device)
    mov_a, fx_a, mov_b, fx_b = vols
    movs, fxs = torch.cat([mov_a, mov_b]), torch.cat([fx_a, fx_b])

    def whole(mov, fx):
        return stage_t(model, mov, stage_u(model, mov, fx))

    def batch2():
        out = model(movs, fxs)
        return [(out["moved"][i:i + 1], out["warp"][i:i + 1]) for i in range(2)]

    def free():
        svf_a, svf_b = stage_u(model, mov_a, fx_a), stage_u(model, mov_b, fx_b)
        return [stage_t(model, mov_a, svf_a), stage_t(model, mov_b, svf_b)]

    if dev.type == "cuda":
        s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

        def interleaved():
            caller = torch.cuda.current_stream(dev)
            s1.wait_stream(caller)
            s2.wait_stream(caller)
            for x in (mov_a, fx_a):
                x.record_stream(s1)
            for x in (mov_b, fx_b):
                x.record_stream(s2)
            u_done = torch.cuda.Event()
            with torch.cuda.stream(s1):
                svf_a = stage_u(model, mov_a, fx_a)
                u_done.record(s1)
                out_a = stage_t(model, mov_a, svf_a)
            with torch.cuda.stream(s2):
                s2.wait_event(u_done)
                out_b = whole(mov_b, fx_b)
            caller.wait_stream(s1)
            caller.wait_stream(s2)
            for x in (*out_a, *out_b):
                x.record_stream(caller)
            return [out_a, out_b]
    else:
        def interleaved():
            svf_a = stage_u(model, mov_a, fx_a)
            out_a = stage_t(model, mov_a, svf_a)
            return [out_a, whole(mov_b, fx_b)]

    return {"single_pair_ms": lambda: [whole(mov_a, fx_a)],
            "batch2_ms_per_pair": batch2,
            "two_seq_ms_per_pair": lambda: [whole(mov_a, fx_a), whole(mov_b, fx_b)],
            "two_interleaved_ms_per_pair": interleaved,
            "two_free_ms_per_pair": free}


def time_arms(fns: dict, device=None, emit=print) -> dict:
    """Times the arms of :func:`arms`; returns the JAX script's record (its
    keys and rounding)."""
    dev = resolve_device(device)
    ms = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            ms[name] = ms_per_call(dev, fn, ITERS, WARMUP, BLOCKS) / (
                1 if name == "single_pair_ms" else 2)
            if name != "two_free_ms_per_pair":
                emit(json.dumps({name: round(ms[name], 1)}))
    results = {name: round(v, 1) for name, v in ms.items()}
    # 2 x a single pair's call over a call of the two interleaved pairs
    results["speedup_interleave_vs_2x_single"] = round(
        ms["single_pair_ms"] / ms["two_interleaved_ms_per_pair"], 3)
    results["backend"] = dev.type
    emit(json.dumps(results))
    return results


def run(shape=SHAPE, device=None, emit=print, cfg: VxmConfig = CFG,
        guard_shape=GUARD_SHAPE) -> dict:
    """The guard, then the five arms timed; returns the JAX script's record."""
    dev = resolve_device(device)
    model, vols, rng = build(shape, dev, cfg)
    guard(model, rng, dev, guard_shape)
    emit(json.dumps({"staged_tail_matches_model": True}))
    return time_arms(arms(model, vols, dev), dev, emit)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    res = run(device=dev)
    write_result(a.out, res)
    return res


if __name__ == "__main__":
    main()
