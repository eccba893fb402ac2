#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py               # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu  # rehearsal: tiny shapes, plain versions

Phases (any failure exits non-zero):
  1. build the hand-written kernels (csrc/*.cu, one nvcc each, in parallel);
  2. hold each of the seven kernels against its plain PyTorch version on the
     card, at the shapes of the flagship forward and of a training step (K2
     and K5 also through their fused squaring step: forward exact, backward,
     the 5-step integration and its device launches), and check that the
     inference-only kernels refuse to be differentiated;
  3. the flagship forward (VxmDense enc [64]x4 / dec [64]x6, int_steps 5,
     svf_res = int_res = 2, bf16) on the in-repo checkpoint at
     (1, 160, 160, 192, 1): kernel path against the plain path, launch
     counts per forward, ms per forward, pairs/s, peak memory, and each
     kernel's wrapper time, device time and device operations per call
     beside its bound, its plain version and a PyTorch yardstick that the
     port never calls;
  4. ``register()`` end to end on a synthetic 1 mm NIfTI pair of that size;
  5. training: one loss-and-backward of the flagship model at full width on
     a fixed synthesised batch, through the kernels against the same through
     their plain versions; then ``run_training`` (label maps generated on the
     card, 26 labels, 160x160x192, batch 1) for 4 steps with the pool
     adjoint's tie rule ``equal`` and one with ``first``: launch counts per
     step, s/step, peak memory, a profile, and each training kernel's time
     beside its bound, its plain version and a PyTorch yardstick;
  6. the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``; it is printed only on
the card and only when every phase passed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "benchmarks", "learned_ref_160x160x192_26lab.npz")
FLAGSHIP = dict(enc=[64] * 4, dec=[64] * 6, int_steps=5, int_res=2, svf_res=2,
                compute_dtype="bfloat16")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bf16_ulp(m: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``m``."""
    return 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def synthetic_pair(shape, seed=0):
    """A tube along z and a copy shifted by 3 voxels in x, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    tube = np.exp(-(g[0] ** 2 + g[1] ** 2) * 12)
    fx = (tube + 0.05 * rng.random(shape)).astype(np.float32)
    mov = (np.roll(tube, 3, 0) + 0.05 * rng.random(shape)).astype(np.float32)
    return fx, mov


def smooth_field(shape, amp, seed, device):
    """Smooth random displacement field ``(1, *shape, 3)`` of amplitude ``amp``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    comps = []
    for _ in range(3):
        k = rng.uniform(1, 4, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        comps.append(amp * np.sin(2 * np.pi * k[0] * axes[0] + ph[0])
                     * np.cos(2 * np.pi * k[1] * axes[1] + ph[1])
                     * np.sin(2 * np.pi * k[2] * axes[2] + ph[2]))
    return torch.as_tensor(np.stack(comps, -1)[None].astype(np.float32), device=device)


class Timer:
    """Median ms per call: CUDA events around ``n`` back-to-back calls,
    repeated ``reps`` times, after ``warmup`` calls."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, n=10, reps=5, warmup=2):
        import torch

        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if self.cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(n):
                    fn()
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b) / n)
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                times.append((time.perf_counter() - t0) * 1000 / n)
        return statistics.median(times)


def _dev_us(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def _profiled(fn, n):
    """Run ``fn`` ``n`` times under ``torch.profiler`` after one warm call.
    Returns the device-side entries (kernels, copies, memsets; operator
    entries on the host would count their kernels' time a second time) and
    the wall time per call in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        time.sleep(0.002)  # let the last device records reach the profiler
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and _dev_us(e) > 0]
    return events, wall_ms


def device_time(fn, what=None, n=10):
    """Device time of everything one call of ``fn`` enqueues, from
    ``torch.profiler``: ``(ms per call, device operations per call, rows)``,
    a row ``(ms, launches per call, name)`` for each operation; with ``what``
    the rows are printed. ``(None, None, [])`` without a card. The profiler
    can miss the first device records of a window, so the window is made long
    (about 30 ms of calls) and each operation counts with its mean duration,
    as often per call as it was seen, rounded."""
    import torch

    if not torch.cuda.is_available():
        return None, None, []
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = min(1000, max(n, int(0.03 / max(time.perf_counter() - t0, 1e-6))))
    events, _ = _profiled(fn, n)
    check(bool(events), f"the profiler recorded no device time for {what or fn}")
    rows = sorted(((_dev_us(e) / e.count / 1e3, max(1, round(e.count / n)), e.key)
                   for e in events), key=lambda r: -r[0] * r[1])
    ms = sum(mean * per_call for mean, per_call, _ in rows)
    ops = sum(per_call for _, per_call, _ in rows)
    if what:
        print(f"#   device time of one {what}: {ms:.4f} ms in {ops} operations")
        for mean, per_call, key in rows:
            print(f"#     {mean * per_call:9.4f} ms  x{per_call:<3d} {key[:90]}")
    return ms, ops, [(mean * per_call, per_call, key) for mean, per_call, key in rows]


def profile_calls(fn, what, n=3, top=10):
    """Where the device time of ``fn()`` goes: ``torch.profiler`` over ``n``
    calls, device time by kernel per call, and the device's busy share of
    the wall time (kernel time summed / wall time)."""
    events, wall_ms = _profiled(fn, n)
    busy_ms = sum(_dev_us(e) for e in events) / 1e3 / n
    if not events:
        print("#   profile: the profiler recorded no device time (not measured)")
        return
    print(f"#   profile ({n} {what}s): device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"per {what} in {sum(e.count for e in events) / n:.0f} device operations, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=_dev_us, reverse=True)[:top]:
        print(f"#     {_dev_us(e) / 1e3 / n:9.4f} ms  x{e.count // n:<3d} {e.key[:90]}")


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, ref, tol, exact=False):
    err = float((got.float() - ref.float()).abs().max())
    ok = err == 0.0 if exact else err <= tol
    print(f"#   {name}: max_abs_err {err:.3e} (tolerance {'exact' if exact else f'{tol:.3e}'})"
          f" {'ok' if ok else 'FAILED'}", flush=True)
    check(ok, f"{name} disagrees with its plain version")
    return err


def grads_of(fn, inputs, cotangent):
    """Gradients of ``sum(fn(*inputs) * cotangent)`` w.r.t. ``inputs``."""
    leaves = [i.detach().requires_grad_() for i in inputs]
    out = fn(*leaves)
    out.backward(cotangent.to(out.dtype))
    return [l.grad for l in leaves]


def distinct_corner_labels(labels, flow):
    """Sum over voxels of the number of distinct labels among the 8 corners
    that the warp of ``labels (1, X, Y, Z)`` by ``flow`` reads: the entries of
    its cotangent that K7's function needs."""
    import torch

    _, X, Y, Z = labels.shape
    hi = torch.tensor([X - 1, Y - 1, Z - 1], device=flow.device)
    grid = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=flow.device)
                                        for s in (X, Y, Z)], indexing="ij"), -1)
    c = torch.minimum(torch.clamp(grid + flow[0], min=0.0), hi.float())
    i0 = torch.floor(c).long()
    i1 = torch.minimum(i0 + 1, hi)
    flat = labels.reshape(-1)
    corner = [flat[((i1 if dx else i0)[..., 0] * Y + (i1 if dy else i0)[..., 1]) * Z
                   + (i1 if dz else i0)[..., 2]]
              for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    srt = torch.stack(corner, -1).sort(dim=-1).values
    return int((srt[..., 1:] != srt[..., :-1]).sum()) + X * Y * Z


def backward_call(fn, inputs, cotangent):
    """A call that runs the backward alone: the forward's graph is built
    once and kept, ``torch.autograd.grad`` runs on it each call."""
    import torch

    leaves = [i.detach().requires_grad_() for i in inputs]
    out = fn(*leaves)
    g = cotangent.to(out.dtype)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def measure(timer, name, bound_, call, plain, library=None, n=10, plain_kw=None):
    """One kernel's row: ``ms`` (CUDA events around back-to-back calls of the
    wrapper), ``device_ms`` and ``device_ops`` (what one call enqueues, from
    the profiler, each operation printed), the plain version and, where one
    PyTorch call computes the same function, that call's two times."""
    row = {"ms": timer(call, n=n), "plain_ms": timer(plain, **(plain_kw or {"n": 3, "reps": 3})),
           "bound": bound_, "library_ms": None, "library_device_ms": None}
    row["device_ms"], row["device_ops"], _ = device_time(call, f"{name} call")
    if library is not None:
        row["library_ms"] = timer(library, n=n)
        row["library_device_ms"], _, _ = device_time(library, f"{name} yardstick call")
    return row


def fused_step_phase(dev, half, results, rehearsal):
    """Phase 2, the fused squaring step (K2's ``self_warp_add``) and its
    backward (K5's) against their plain versions. Forward: exact, the kernel
    repeats the cast, the warp, the cast back and the add bit for bit.
    Backward against autograd of the plain version: float32 payload 1e-5 of
    the largest gradient (the same products summed in another order, through
    atomics, so the last bits change from run to run); bf16 payload 4 bf16 ulp
    of the largest gradient (the plain version rounds every contribution to
    bf16 and scatters in bf16, the kernel sums in float32 and rounds once).
    With a bf16 payload both are also held against the backward's formula
    summed in float64 (``self_warp_add_grad_float64``), which has the
    kernel's roundings of the cotangent and of the volume term and no other:
    the kernel within 2 bf16 ulp of it, and each side's gap is printed. Where
    many contributions meet in one voxel (the +-40 field and the constant
    shift clamp whole slabs to the border) the plain bf16 scatter drifts by
    more than 4 ulp; there the kernel may differ from it by 4 ulp plus the
    plain version's own gap to the float64 formula, as measured in this run.
    The report's ``fused_max_abs_err`` of K5 is the largest error against the
    float64 formula (bf16 payload) and the plain version (float32 payload)."""
    import numpy as np
    import torch

    from multimodal_registration_torch.ops.warp import (
        self_warp_add_batch, self_warp_add_grad_float64)

    rng = np.random.default_rng(11)
    odd = (37, 41, 50) if not rehearsal else (9, 7, 10)
    fields = {
        "smooth |phi|<=2": smooth_field(half, 2.0, 1, dev),
        "+-40 (defeats the window)": torch.as_tensor(
            rng.uniform(-40, 40, (1, *half, 3)).astype(np.float32), device=dev),
        "constant 10-voxel shift": torch.full((1, *half, 3), 10.0, device=dev),
        "batch 2": torch.cat([smooth_field(half, 2.0, 12, dev), smooth_field(half, 0.05, 13, dev)]),
        f"shape {odd} that no tile divides": smooth_field(odd, 3.0, 14, dev),
    }
    err_f, err_b = [], []
    for label, phi in fields.items():
        cot = torch.as_tensor(rng.normal(size=tuple(phi.shape)).astype(np.float32), device=dev)
        for payload, name in ((torch.bfloat16, "bf16"), (None, "f32")):
            err_f.append(compare(
                f"K2 self_warp_add {name} payload, {label}", self_warp_add_batch(phi, payload),
                self_warp_add_batch(phi, payload, impl="plain"), 0.0, exact=True))
            (gk,) = grads_of(lambda f: self_warp_add_batch(f, payload), [phi], cot)
            (gp,) = grads_of(lambda f: self_warp_add_batch(f, payload, impl="plain"), [phi], cot)
            m = float(gp.abs().max())
            what = f"K5 self_warp_add backward {name} payload, {label}"
            if payload is None:
                err_b.append(compare(f"{what}, against autograd of the plain version "
                                     f"(max {m:.3f})", gk, gp, 1e-5 * max(m, 1.0)))
                continue
            g64 = self_warp_add_grad_float64(phi, cot, payload)
            gap_plain = float((gp - g64).abs().max())
            err_b.append(compare(
                f"{what}, against the float64 formula (2 bf16 ulp of max {m:.3f}; the "
                f"plain version's gap to it is {gap_plain:.3e})", gk, g64, 2 * bf16_ulp(m)))
            heavy = label.startswith(("+-40", "constant"))
            compare(f"{what}, against autograd of the plain version (4 bf16 ulp"
                    f"{' + the plain gap' if heavy else ''})", gk, gp,
                    4 * bf16_ulp(m) + (gap_plain if heavy else 0.0))
    results["warp_trilinear"]["fused_max_abs_err"] = max(err_f)
    results["warp_trilinear_bwd"]["fused_max_abs_err"] = max(err_b)


TRAIN_WANT = {"conv3_lrelu_pool": 0, "warp_trilinear": 11, "warp_up2x": 0,
              "max_pool_2x_bwd": 4, "warp_trilinear_bwd": 6,
              "warp_labels_soft_hard": 3, "warp_labels_bwd": 1}


def training_kernels_phase(dev, shape, timer, results, timing, rehearsal):
    """Phase 2, second half: K4-K7 against their plain versions at a training
    step's largest shapes, F4 (K2 differentiable, K1 and K3 refuse), and
    each kernel's time beside its bound, plain version and yardstick."""
    import torch
    import torch.nn.functional as F

    from multimodal_registration_torch.ops.conv_pool import conv3_lrelu_pool
    from multimodal_registration_torch.ops.integrate import integrate_svf_batch
    from multimodal_registration_torch.ops.pool import max_pool_2x_bwd
    from multimodal_registration_torch.ops.warp import (
        self_warp_add_batch, warp_batch, warp_labels_soft_hard_batch, warp_onehot_batch,
        warp_up2x_batch)

    half = tuple(s // 2 for s in shape)
    nfull, nhalf = math.prod(shape), math.prod(half)
    gen = torch.Generator(device=dev).manual_seed(7)
    C, L = (64, 26) if not rehearsal else (8, 6)

    # K4: bf16 at enc_0's shape, values on a coarse grid so that windows tie
    x = (torch.randint(-6, 7, (1, *shape, C), generator=gen, device=dev) * 0.25).bfloat16()
    g = torch.randn((1, *half, C), generator=gen, device=dev).bfloat16()
    win = x.reshape(1, half[0], 2, half[1], 2, half[2], 2, C)
    ties = 8 * float((win == win.amax(dim=(2, 4, 6), keepdim=True)).float().mean())
    del win
    print(f"#   K4 input: {ties:.2f} voxels per window equal its max (1 = no ties)")
    errs = [compare(f"K4 max_pool_2x_bwd bf16 {tie} {tuple(x.shape)}",
                    max_pool_2x_bwd(x, g, tie), max_pool_2x_bwd(x, g, tie, impl="plain"),
                    0.0, exact=True) for tie in ("equal", "first")]
    results["max_pool_2x_bwd"]["max_abs_err"] = max(errs)
    t_k4f = timer(lambda: max_pool_2x_bwd(x, g, "first"))
    xc = x.permute(0, 4, 1, 2, 3)
    timing["max_pool_2x_bwd"] = measure(
        timer, "max_pool_2x_bwd", bound((2 * x.numel() + g.numel()) * 2, x.numel() * 3, FP32_FLOPS),
        lambda: max_pool_2x_bwd(x, g, "equal"),
        lambda: max_pool_2x_bwd(x, g, "equal", impl="plain"),
        backward_call(lambda v: F.max_pool3d(v, 2, 2), [xc], g.permute(0, 4, 1, 2, 3)), n=5)
    print(f"#   max_pool_2x_bwd tie=first: {t_k4f:.4f} ms")
    del x, g, xc

    # K5: both gradients at the integration grid, bf16 and f32 payload
    flow = smooth_field(half, 2.0, 3, dev)
    cot = torch.randn((1, *half, 3), generator=gen, device=dev)
    errs = []
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        vol = smooth_field(half, 2.0, 4, dev).to(dt)
        gk = grads_of(lambda v, f: warp_batch(v, f), [vol, flow], cot)
        gp = grads_of(lambda v, f: warp_batch(v, f, impl="plain"), [vol, flow], cot)
        mv, mf = float(gp[0].float().abs().max()), float(gp[1].abs().max())
        # float32: the same products summed in another order (atomics); bf16:
        # the plain version scatters in bf16, K5 sums in f32 and rounds once
        tol_v = 1e-5 * max(mv, 1.0) if dt == torch.float32 else 4 * bf16_ulp(mv)
        e1 = compare(f"K5 warp_trilinear_bwd {name} payload, grad volume (max {mv:.3f})",
                     gk[0], gp[0], tol_v)
        e2 = compare(f"K5 warp_trilinear_bwd {name} payload, grad flow (max {mf:.3f})",
                     gk[1], gp[1], 1e-4 * max(mf, 1.0))
        errs += [e1, e2] if dt == torch.float32 else [e2]
        if dt == torch.bfloat16:
            vol_b = vol
    results["warp_trilinear_bwd"]["max_abs_err"] = max(errs)
    hgrid = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                                         for s in half], indexing="ij"), -1)
    dims = torch.tensor(half, dtype=torch.float32, device=dev) - 1
    gnorm = ((hgrid + flow[0]) / dims * 2 - 1).flip(-1)[None].contiguous()
    k5_library = backward_call(
        lambda v, gr: F.grid_sample(v, gr, mode="bilinear", padding_mode="border",
                                    align_corners=True),
        [vol_b.float().permute(0, 4, 1, 2, 3).contiguous(), gnorm],
        cot.permute(0, 4, 1, 2, 3).contiguous())
    # read: bf16 volume and cotangent, f32 flow; written: bf16 grad volume,
    # f32 grad flow; ~60 f32 operations per output value
    timing["warp_trilinear_bwd"] = measure(
        timer, "warp_trilinear_bwd",
        bound(nhalf * 3 * (2 + 2 + 4 + 2 + 4), nhalf * 3 * 60, FP32_FLOPS),
        backward_call(lambda v, f: warp_batch(v, f), [vol_b, flow], cot),
        backward_call(lambda v, f: warp_batch(v, f, impl="plain"), [vol_b, flow], cot),
        k5_library, n=20)
    # the fused step's backward, on the same field: float32 field, cotangent
    # and scratch read, float32 gradient written
    timing["warp_trilinear_bwd"]["fused"] = measure(
        timer, "self_warp_add backward (K5's fused entry)",
        bound(nhalf * 3 * 4 * 3, nhalf * 3 * 60, FP32_FLOPS),
        backward_call(lambda f: self_warp_add_batch(f, torch.bfloat16), [flow], cot),
        backward_call(lambda f: self_warp_add_batch(f, torch.bfloat16, impl="plain"), [flow], cot),
        k5_library, n=20)

    # F4: the integration is differentiable through K2/K5; K1 and K3 refuse
    vel = smooth_field(half, 3.0, 5, dev)
    (gk,) = grads_of(lambda v: integrate_svf_batch(v, 5, torch.bfloat16), [vel], cot)
    (gp,) = grads_of(lambda v: integrate_svf_batch(v, 5, torch.bfloat16, impl="plain"), [vel], cot)
    check(float(gk.abs().max()) > 0, "F4: the integration's gradient on the card is zero")
    for payload, name in ((torch.bfloat16, "bf16"), (None, "f32")):
        with torch.no_grad():
            compare(f"integrate_svf_batch, 5 fused steps, {name} payload",
                    integrate_svf_batch(vel, 5, payload),
                    integrate_svf_batch(vel, 5, payload, impl="plain"), 0.0, exact=True)
    compare("F4 d integrate_svf_batch / d svf, bf16 payload (5% of max: the plain version "
            "scatters in bf16 at each of five steps, K5 sums in float32)", gk, gp,
            0.05 * float(gp.abs().max()))
    # the whole integration of a forward and of a step's backward, as the
    # paths run it: device launches and device time
    def integration_forward():
        with torch.inference_mode():
            integrate_svf_batch(vel, 5, torch.bfloat16)

    integ = {"fwd_ms": timer(integration_forward, n=5)}
    integ["fwd_device_ms"], integ["fwd_device_ops"], fwd_rows = device_time(
        integration_forward, "5-step integration, forward")
    integration_backward = backward_call(lambda v: integrate_svf_batch(v, 5, torch.bfloat16),
                                         [vel], cot)
    integ["bwd_ms"] = timer(integration_backward, n=5)
    integ["bwd_device_ms"], integ["bwd_device_ops"], bwd_rows = device_time(
        integration_backward, "5-step integration, backward")

    # the same integration through the general kernels alone, as it ran before
    # the fused step existed: cast, K2, cast back and add, four launches a step
    def unfused(v):
        phi = v / 32.0
        for _ in range(5):
            phi = phi + warp_batch(phi.bfloat16(), phi).float()
        return phi

    def unfused_forward():
        with torch.inference_mode():
            unfused(vel)

    integ["unfused_fwd_device_ms"], integ["unfused_fwd_device_ops"], _ = device_time(
        unfused_forward, "5-step integration through the general K2, forward")
    integ["unfused_bwd_device_ms"], integ["unfused_bwd_device_ops"], _ = device_time(
        backward_call(unfused, [vel], cot),
        "5-step integration through the general K2 and K5, backward")

    def launches_of(rows, *names):
        return sum(per_call for _, per_call, key in rows if any(n in key for n in names))

    if dev.type == "cuda":
        steps_fwd = launches_of(fwd_rows, "self_warp_add_kernel")
        steps_bwd = launches_of(bwd_rows, "self_warp_add_bwd_kernel", "self_warp_add_finish_kernel")
        memsets = launches_of(bwd_rows, "Memset", "FillFunctor")
        print(f"#   the 5 squaring steps of a forward: {steps_fwd} device launches (of "
              f"{integ['fwd_device_ops']} in the integration; the rest is v / 32); their "
              f"backward: {steps_bwd} kernels (A and B per step) and {memsets} memsets (of "
              f"{integ['bwd_device_ops']} operations)")
        check(steps_fwd == 5 and steps_bwd == 10 and memsets == 0,
              "the squaring steps are not one launch each forward and two backward")
    print(f"#   integration (5 squaring steps, bf16 payload, {tuple(vel.shape)}): {json.dumps(integ)}")
    if dev.type == "cuda":
        w = torch.zeros((4, 2, 3, 3, 3), device=dev, requires_grad=True)
        for label, call in (
            ("K1", lambda: conv3_lrelu_pool(torch.zeros((1, 8, 8, 8, 2), device=dev), w,
                                            torch.zeros(4, device=dev))),
            ("K3", lambda: warp_up2x_batch(torch.zeros((1, 8, 8, 8, 1), device=dev),
                                           torch.zeros((1, 4, 4, 4, 3), device=dev,
                                                       requires_grad=True))),
        ):
            try:
                call()
            except NotImplementedError as e:
                print(f"#   F4 {label} refuses a gradient: {str(e)[:60]}...")
            else:
                fail(f"F4: {label} returned a tensor although a gradient was asked of it")

    # K6 / K7 at full resolution, 26 labels
    coarse = torch.randint(0, L, (1, *(max(s // 8, 1) for s in shape)), generator=gen,
                           device=dev, dtype=torch.uint8)
    labels = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2).repeat_interleave(8, 3)
    labels = labels[:, :shape[0], :shape[1], :shape[2]].contiguous()
    lflow = smooth_field(shape, 3.0, 6, dev)
    soft, hard = warp_labels_soft_hard_batch(labels, lflow, L)
    psoft, phard = warp_labels_soft_hard_batch(labels, lflow, L, impl="plain")
    compare("K6 warp_labels_soft_hard hard labels", hard, phard, 0.0, exact=True)
    results["warp_labels_soft_hard"]["max_abs_err"] = compare(
        "K6 warp_labels_soft_hard soft map", soft, psoft, 1e-6)
    hflow = torch.full((1, *shape, 3), 0.5, device=dev)
    compare("K6 hard labels, flow +0.5 (F1: half to even)",
            warp_labels_soft_hard_batch(labels, hflow, L)[1],
            warp_labels_soft_hard_batch(labels, hflow, L, impl="plain")[1], 0.0, exact=True)
    del psoft, phard, hflow, soft, hard
    lcot = torch.randn((1, *shape, L), generator=gen, device=dev)
    (gk,) = grads_of(lambda f: warp_onehot_batch(labels, f, L), [lflow], lcot)
    (gp,) = grads_of(lambda f: warp_onehot_batch(labels, f, L, impl="plain"), [lflow], lcot)
    results["warp_labels_bwd"]["max_abs_err"] = compare(
        f"K7 warp_labels_bwd grad flow (max {float(gp.abs().max()):.3f})", gk, gp,
        1e-5 * max(float(gp.abs().max()), 1.0))
    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    timing["warp_labels_soft_hard"] = measure(
        timer, "warp_labels_soft_hard",
        bound(nfull * (1 + 12 + 4 * L + 4), nfull * (40 + 8 * L), FP32_FLOPS),
        no_grad(lambda: warp_labels_soft_hard_batch(labels, lflow, L)),
        no_grad(lambda: warp_labels_soft_hard_batch(labels, lflow, L, impl="plain")),
        plain_kw={"n": 2, "reps": 3})
    # K7 reads of its cotangent only the entries at the corner labels: count
    # what this run's labels and flow need, not all L entries of every voxel
    needed = distinct_corner_labels(labels, lflow)
    print(f"#   K7 reads {needed / nfull:.3f} cotangent entries per voxel of {L} "
          "(distinct corner labels)")
    timing["warp_labels_bwd"] = measure(
        timer, "warp_labels_bwd",
        bound(4 * needed + nfull * (1 + 12 + 12), nfull * 80, FP32_FLOPS),
        backward_call(lambda f: warp_onehot_batch(labels, f, L), [lflow], lcot),
        backward_call(lambda f: warp_onehot_batch(labels, f, L, impl="plain"), [lflow], lcot),
        plain_kw={"n": 2, "reps": 3})


def training_phase(dev, shape, timer, rehearsal, tmp):
    """Phase 5: the flagship model's training at full width. Returns
    ``(launches of the run_training run, numbers to print)``."""
    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.models.weights import grads_to_jax
    from multimodal_registration_torch.train.cli import run_training
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import (
        Trainer, loss_from_batch, synthesize)

    width = 64 if not rehearsal else 8
    base = dict(in_shape=list(shape), num_labels=26 if not rehearsal else 6, num_maps=4,
                enc=[width] * 4, dec=[width] * 6, batch_size=1, save_label=False, verbose=0,
                model_dir=os.path.join(tmp, "models"), log_dir=os.path.join(tmp, "logs"),
                label_dir=os.path.join(tmp, "labels"))
    cfg = TrainConfig.from_dict(dict(base))
    check((cfg.int_steps, cfg.svf_res, cfg.int_res, cfg.compute_dtype, cfg.svf_int_res,
           cfg.compose_res, cfg.grad_res) == (5, 2, 2, "bfloat16", 4, 2, 1),
          "TrainConfig defaults are not the flagship's")

    # -- one loss-and-backward on a fixed batch: kernels against plain versions
    trainer = Trainer(cfg, device=dev)
    with torch.no_grad():  # a flow head far from zero, so that every branch carries signal
        trainer.model.flow.weight.mul_(2000.0)
    coarse = torch.randint(0, cfg.num_labels, (2, *(max(s // 8, 1) for s in shape)),
                           generator=trainer.generator(1), device=dev, dtype=torch.uint8)
    maps = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2).repeat_interleave(8, 3)
    maps = maps[:, :shape[0], :shape[1], :shape[2]].contiguous()
    batch = synthesize(trainer.generator(2), maps[:1], maps[1:], trainer.engine_cfg, cfg, False)
    sides = {}
    for impl in (None, "plain"):
        trainer.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_from_batch(trainer.model, batch, trainer.engine_cfg, cfg, False, impl)
        loss.backward()
        sides[impl] = (float(loss.detach()), grads_to_jax(trainer.model))
    (lk, gk), (lp, gp) = sides[None], sides["plain"]
    # both sides run the same cuDNN convs; they differ where K5 sums the
    # bf16 integration's cotangents in float32 (the plain version scatters in
    # bf16), and where cuDNN's backward picks another summation order
    print(f"#   fixed batch: loss kernels {lk:.6f}, plain {lp:.6f} (tolerance 1e-3)")
    check(abs(lk - lp) <= 1e-3, "loss through the kernels disagrees with the plain path")
    worst = 0.0
    for name, ref in gp.items():
        rel = float(np.abs(gk[name] - ref).max() / max(np.abs(ref).max(), 1e-30))
        cos = float((gk[name] * ref).sum()
                    / max(np.linalg.norm(gk[name]) * np.linalg.norm(ref), 1e-30))
        worst = max(worst, rel)
        check(np.isfinite(gk[name]).all() and np.abs(ref).max() > 0,
              f"gradient of {name} is not finite or zero")
        check(rel <= 0.1 and cos >= 0.995,
              f"gradient of {name}: kernels vs plain max diff {rel:.3e} of max, cosine {cos:.5f}")
    print(f"#   fixed batch: {len(gp)} parameter gradients, worst max-diff {worst:.3e} of the "
          "leaf's max (tolerance 0.1, cosine >= 0.995)", flush=True)
    del trainer, batch, sides, gk, gp

    # -- run_training, the entry point a user calls: 4 steps, tie "equal"
    kernels.reset_launch_counts()
    out = run_training(cfg, max_steps=4, device=dev, pool_tie="equal")
    launches = kernels.launch_counts()
    print(f"#   launches in run_training (label maps, 4 steps, 2 validation steps): {launches}")
    check(out["steps"] == 4, f"run_training took {out['steps']} steps, not 4")
    for row in out["history"]:
        check(all(np.isfinite(row[k]) for k in ("loss", "dice_loss", "grad_loss", "val_loss")),
              f"training metrics are not finite: {row}")
        print(f"#   epoch {row['epoch']}: loss {row['loss']:.5f} dice {row['dice_loss']:.5f} "
              f"grad {row['grad_loss']:.3e} val {row['val_loss']:.5f}")
    with np.load(os.path.join(cfg.model_dir, "0000.npz")) as z0, \
            np.load(os.path.join(cfg.model_dir, "final.npz")) as z1:
        same = [k for k in z0 if np.array_equal(z0[k], z1[k])]
        check(len(z0.files) == 22 and not same, f"parameters that did not change: {same}")
    trainer = out["trainer"]
    check(next(trainer.model.parameters()).device.type == dev.type, "the model is not on the device")

    # -- launches of one step, s/step, peak memory, profile
    bank = trainer.put_bank(maps.cpu().numpy())
    si, ti = trainer.put_indices(np.array([0]), np.array([1]))
    gen = trainer.generator(3)
    kernels.reset_launch_counts()
    trainer.train_step_banked(gen, bank, si, ti)
    per_step = kernels.launch_counts()
    print(f"#   launches per training step: {per_step}")
    if not rehearsal:
        check(per_step == TRAIN_WANT, f"a step launched {per_step}, want {TRAIN_WANT}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step_ms = timer(lambda: trainer.train_step_banked(gen, bank, si, ti), n=1, reps=7, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else float("nan")
    host = sorted(out["step_seconds"])
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"#   training step: {step_ms / 1e3:.4f} s/step median of 7 ({clock}), peak memory "
          f"{peak:.1f} MiB; run_training's own steps (host clock) min {host[0]:.4f} s, "
          f"max {host[-1]:.4f} s", flush=True)
    if not rehearsal:
        profile_calls(lambda: trainer.train_step_banked(gen, bank, si, ti), "step", top=14)

    # -- one more run with the Pallas kernels' tie rule
    cfg1 = TrainConfig.from_dict(dict(base, num_maps=2, model_dir=os.path.join(tmp, "m_first"),
                                      log_dir=os.path.join(tmp, "l_first")))
    kernels.reset_launch_counts()
    out1 = run_training(cfg1, max_steps=1, device=dev, pool_tie="first")
    first = kernels.launch_counts()
    check(np.isfinite(out1["history"][0]["loss"])
          and (rehearsal or first["max_pool_2x_bwd"] == 4),
          f"the step with tie='first' failed: {out1['history']}, {first}")
    print(f"#   one step with pool_tie='first': loss {out1['history'][0]['loss']:.5f}, "
          f"K4 launches {first['max_pool_2x_bwd']}")
    return launches, {"step_s": step_ms / 1e3, "train_peak_mib": peak}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for a tiny-shape rehearsal")
    args = ap.parse_args()
    t_start = time.time()

    import numpy as np
    import torch

    rehearsal = args.device == "cpu"
    if not rehearsal and not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from multimodal_registration_torch import kernels
        from multimodal_registration_torch.infer.config import InferenceConfig
        from multimodal_registration_torch.infer.register import (
            Registrar, load_params_any, register)
        from multimodal_registration_torch.models.vxm_dense import VxmDense
        from multimodal_registration_torch.ops.conv_pool import conv3_lrelu_pool
        from multimodal_registration_torch.ops.warp import (
            clear_scratch, sample, self_warp_add_batch, warp_batch, warp_up2x_batch)
        from multimodal_registration_torch.utils import nifti
    except ImportError as e:
        fail(f"the port's package is not next to this script ({e})")
    # the kernels must build from this checkout's sources, not an installed copy
    check(os.path.dirname(os.path.abspath(kernels.__file__))
          == os.path.join(HERE, "multimodal_registration_torch"),
          f"imported the port from {kernels.__file__}, not from {HERE}")
    check(os.path.exists(CKPT), f"checkpoint {CKPT} missing")

    dev = torch.device(args.device)
    shape = (32, 32, 48) if rehearsal else (160, 160, 192)
    half = tuple(s // 2 for s in shape)
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {dev}, shape {shape}", flush=True)

    # ---- 1. build -----------------------------------------------------------
    if not rehearsal:
        t0 = time.perf_counter()
        log = kernels.build()
        print(f"# phase 1 build: {time.perf_counter() - t0:.2f} s wall", flush=True)
        for src, info in log.items():
            print(f"#   {src}: {info['seconds']:.2f} s -> {info['path']}")
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"#     {line.strip()}")
        out = subprocess.run(["nvcc", "--version"], capture_output=True, text=True)
        print("# " + (out.stdout.strip().splitlines() or ["nvcc ?"])[-1])

    results = {k.name: {"max_abs_err": 0.0} for k in kernels.KERNELS}

    # ---- 2. each kernel against its plain version ---------------------------
    print("# phase 2: kernels against their plain versions", flush=True)
    x1 = torch.as_tensor(rng.normal(size=(1, *shape, 2)).astype(np.float32), device=dev).bfloat16()
    w1 = torch.as_tensor(rng.normal(scale=0.2, size=(64, 2, 3, 3, 3)).astype(np.float32), device=dev)
    b1 = torch.as_tensor(rng.normal(scale=0.1, size=(64,)).astype(np.float32), device=dev)
    k1 = conv3_lrelu_pool(x1, w1, b1)
    p1 = conv3_lrelu_pool(x1, w1, b1, impl="plain")
    results["conv3_lrelu_pool"]["max_abs_err"] = compare(
        "K1 conv3_lrelu_pool bf16 (tol 1 bf16 ulp of max|out|)", k1, p1,
        bf16_ulp(float(p1.float().abs().max())))

    phi = smooth_field(half, 2.0, 1, dev)
    errs = []
    for label, flow in (
        ("smooth |flow|<=2", phi),
        ("clamped +-40", torch.as_tensor(rng.uniform(-40, 40, (1, *half, 3)).astype(np.float32), device=dev)),
    ):
        kk = warp_batch(phi.bfloat16(), flow)
        pp = warp_batch(phi.bfloat16(), flow, impl="plain")
        errs.append(compare(f"K2 warp_trilinear bf16 payload, {label} (tol 1 bf16 ulp)", kk, pp,
                            bf16_ulp(float(pp.float().abs().max()))))
    vol_r = torch.as_tensor(rng.normal(size=(1, *half, 3)).astype(np.float32), device=dev).bfloat16()
    half_flow = torch.full((1, *half, 3), 0.5, device=dev)
    compare("K2 warp_trilinear nearest, flow +0.5 (F1: half to even)",
            warp_batch(vol_r, half_flow, interp="nearest"),
            warp_batch(vol_r, half_flow, interp="nearest", impl="plain"), 0.0, exact=True)
    img = torch.as_tensor(rng.random(shape).astype(np.float32), device=dev)
    grid = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                                        for s in shape], indexing="ij"), -1)
    coords = grid * 0.97 + 1.3
    errs.append(compare("K2 warp_trilinear f32, absolute coords (sample)",
                        sample(img, coords), sample(img, coords, impl="plain"), 1e-5))
    results["warp_trilinear"]["max_abs_err"] = max(errs)
    fused_step_phase(dev, half, results, rehearsal)

    mov_img = torch.as_tensor(rng.random((1, *shape, 1)).astype(np.float32), device=dev)
    fh = smooth_field(half, 3.0, 2, dev)
    results["warp_up2x"]["max_abs_err"] = compare(
        "K3 warp_up2x f32", warp_up2x_batch(mov_img, fh),
        warp_up2x_batch(mov_img, fh, impl="plain"), 1e-5)

    timing = {}
    training_kernels_phase(dev, shape, timer, results, timing, rehearsal)
    # K5's cached scratch buffers of phase 2 would count in the forward's peak
    # memory; a serving process, which runs no backward, has none
    clear_scratch()

    # ---- 3. the flagship forward --------------------------------------------
    print("# phase 3: flagship forward", flush=True)
    cfg = InferenceConfig.from_dict(dict(FLAGSHIP))
    params = load_params_any(CKPT, cfg)
    reg = Registrar(cfg, params, device=dev)
    model = reg.model
    check(isinstance(model, VxmDense), "Registrar holds no VxmDense")
    fx_np, mov_np = synthetic_pair(shape)
    mov_t = torch.as_tensor(mov_np, device=dev)[None, ..., None]
    fx_t = torch.as_tensor(fx_np, device=dev)[None, ..., None]
    with torch.inference_mode():
        kernels.reset_launch_counts()
        out_k = model(mov_t, fx_t)
        per_fwd = kernels.launch_counts()
        out_p = model(mov_t, fx_t, impl="plain")
    print(f"#   launches per forward: {per_fwd}")
    if not rehearsal:
        want = dict.fromkeys(per_fwd, 0)
        want.update({"conv3_lrelu_pool": 1, "warp_trilinear": 5, "warp_up2x": 1})
        check(per_fwd == want, f"forward launched {per_fwd}, want K1 x1, K2 x5, K3 x1 only")
    for k in ("moved", "warp"):
        check(bool(torch.isfinite(out_k[k]).all()), f"forward {k} not finite")
    check(tuple(out_k["moved"].shape) == (1, *shape, 1), "moved has the wrong shape")
    check(tuple(out_k["warp"].shape) == (1, *half, 3), "warp has the wrong shape")
    # kernel vs plain differ only where K1's f32 sums round to the other bf16
    # neighbour than cuDNN's; those 1-ulp flips run through the bf16 network
    d_warp = float((out_k["warp"] - out_p["warp"]).abs().max())
    d_moved = float((out_k["moved"] - out_p["moved"]).abs().max())
    print(f"#   kernel vs plain: warp max_abs_diff {d_warp:.3e} voxel (tol 0.1), "
          f"moved max_abs_diff {d_moved:.3e} (tol 0.05, intensities in [0, 1]); "
          f"max|warp| {float(out_p['warp'].abs().max()):.3f}")
    check(d_warp <= 0.1 and d_moved <= 0.05, "kernel forward disagrees with the plain forward")

    with torch.inference_mode():
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        fwd_ms = timer(lambda: model(mov_t, fx_t), n=1, reps=12, warmup=3)
        plain_fwd_ms = timer(lambda: model(mov_t, fx_t, impl="plain"), n=1, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else float("nan")
    clock = "CUDA events" if dev.type == "cuda" else "host clock, CPU"
    print(f"#   forward: {fwd_ms:.3f} ms median of 12 ({clock}), {1000 / fwd_ms:.3f} pairs/s, "
          f"peak memory {peak:.1f} MiB; plain-path forward {plain_fwd_ms:.3f} ms", flush=True)
    if not rehearsal:
        def one_forward():
            with torch.inference_mode():
                model(mov_t, fx_t)

        profile_calls(one_forward, "forward")

    # each kernel at the path's shapes, beside its bound, plain and yardstick
    import torch.nn.functional as F

    xk = torch.cat([mov_t, fx_t], -1).bfloat16().contiguous()
    wk = model.unet.enc_0.conv.weight.detach()
    bk = model.unet.enc_0.conv.bias.detach()
    phi_k = out_k["warp"].contiguous()
    def inference(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    with torch.inference_mode():
        xc = xk.permute(0, 4, 1, 2, 3)
        wkb, bkb = wk.bfloat16(), bk.bfloat16()
        pb = phi_k.bfloat16()
        # grid_sample's grid is (z, y, x)-ordered and normalised to [-1, 1]
        hgrid = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                                             for s in half], indexing="ij"), -1)
        dims = torch.tensor(half, dtype=torch.float32, device=dev) - 1
        gnorm = ((hgrid + phi_k[0]) / dims * 2 - 1).flip(-1)[None].contiguous()
        vin = phi_k.permute(0, 4, 1, 2, 3).contiguous()

    nfull, nhalf = math.prod(shape), math.prod(half)
    b_k1 = bound(nfull * 2 * 2 + wk.numel() * 4 + bk.numel() * 4 + nhalf * 64 * 2,
                 2 * 27 * 2 * 64 * nfull, BF16_TENSOR_FLOPS)
    simt_k1 = 2 * 27 * 2 * 64 * nfull / FP32_FLOPS * 1e3
    # K2: f32 flow read, bf16 payload read, bf16 written; ~16 f32 ops per
    # output value (8 products, 7 sums, the weights) on the SIMT units
    b_k2 = bound(nhalf * 3 * 4 + nhalf * 3 * 2 * 2, nhalf * 3 * 16, FP32_FLOPS)
    b_k3 = bound(nfull * 4 * 2 + nhalf * 3 * 4, nfull * (16 + 3 * 8), FP32_FLOPS)
    timing["conv3_lrelu_pool"] = measure(
        timer, "conv3_lrelu_pool", b_k1,
        inference(lambda: conv3_lrelu_pool(xk, wk, bk)),
        inference(lambda: conv3_lrelu_pool(xk, wk, bk, impl="plain")),
        inference(lambda: F.max_pool3d(F.leaky_relu(F.conv3d(xc, wkb, bkb, padding=1), 0.2), 2)),
        plain_kw={"n": 3})
    timing["warp_trilinear"] = measure(
        timer, "warp_trilinear", b_k2,
        inference(lambda: warp_batch(pb, phi_k)),
        inference(lambda: warp_batch(pb, phi_k, impl="plain")),
        inference(lambda: F.grid_sample(vin, gnorm, mode="bilinear", padding_mode="border",
                                        align_corners=True)), n=20, plain_kw={"n": 5})
    k2_library = timing["warp_trilinear"]
    # the fused step on the same field: float32 field read, float32 field written
    timing["warp_trilinear"]["fused"] = measure(
        timer, "self_warp_add (K2's fused entry)",
        bound(nhalf * 3 * 4 * 2, nhalf * 3 * 18, FP32_FLOPS),
        inference(lambda: self_warp_add_batch(phi_k, torch.bfloat16)),
        inference(lambda: self_warp_add_batch(phi_k, torch.bfloat16, impl="plain")),
        n=20, plain_kw={"n": 5})
    for key in ("library_ms", "library_device_ms"):  # the same yardstick, timed above
        timing["warp_trilinear"]["fused"][key] = k2_library[key]
    timing["warp_up2x"] = measure(
        timer, "warp_up2x", b_k3,
        inference(lambda: warp_up2x_batch(mov_t, phi_k)),
        inference(lambda: warp_up2x_batch(mov_t, phi_k, impl="plain")), n=20, plain_kw={"n": 5})

    def ms_or(v, none="n/a"):
        return none if v is None else f"{v:.4f} ms"

    rows = dict(timing)
    for name in ("warp_trilinear", "warp_trilinear_bwd"):
        rows[f"{name}, fused squaring step"] = timing[name]["fused"]
    for name, row in rows.items():
        print(f"#   {name}: {row['ms']:.4f} ms wrapper, {ms_or(row['device_ms'])} device in "
              f"{row['device_ops']} operations, {row['plain_ms']:.4f} ms plain, "
              f"{ms_or(row['library_ms'])} yardstick ({ms_or(row['library_device_ms'])} device), "
              f"bound {row['bound'][0]:.4f} ms ({row['bound'][1]})")
    print(f"#   conv3_lrelu_pool on FP32 SIMT units (this kernel's path): {simt_k1:.4f} ms")

    # ---- 4. register() end to end (the main path a user calls) -------------
    print("# phase 4: register() end to end", flush=True)
    with tempfile.TemporaryDirectory() as td:
        fxp, movp = os.path.join(td, "fx.nii.gz"), os.path.join(td, "mov.nii.gz")
        nifti.save(nifti.NiftiImage(fx_np, np.eye(4)), fxp)
        nifti.save(nifti.NiftiImage(mov_np, np.eye(4)), movp)
        res_dir = os.path.join(td, "res")
        kernels.reset_launch_counts()
        out = register(cfg, reg, fxp, movp, fx_contrast="T2w", naming="standalone",
                       res_dir=res_dir)
        launches = kernels.launch_counts()
        print(f"#   launches in register(): {launches}")
        print(f"#   timings (s): {json.dumps(out['timings'])}")
        names = ["fx_proc.nii.gz", "mov_proc.nii.gz", "mov_proc_reg_to_T2w.nii.gz",
                 "mov_proc_field_to_T2w.nii.gz", "res/warped_im.nii.gz",
                 "res/deform_field.nii.gz"]
        for n in names:
            check(os.path.exists(os.path.join(td, n)), f"register() did not write {n}")
        field = nifti.load(os.path.join(res_dir, "deform_field.nii.gz"))
        check(field.header["intent_code"] == 1007, "deform_field intent is not 1007")
        check(field.shape == (*shape, 1, 3), f"deform_field shape {field.shape}")
        warped = nifti.load(os.path.join(res_dir, "warped_im.nii.gz")).get_fdata()
        check(bool(np.isfinite(field.get_fdata()).all() and np.isfinite(warped).all()),
              "register() outputs are not finite")
        mse0 = float(np.mean((mov_np - fx_np) ** 2))
        mse1 = float(np.mean((out["moved"] - fx_np) ** 2))
        print(f"#   MSE to fixed: moving {mse0:.5f}, moved {mse1:.5f}")
    serving = ("conv3_lrelu_pool", "warp_trilinear", "warp_up2x")
    if not rehearsal:
        check(all(launches[k] >= 1 for k in serving),
              f"a kernel of the serving path was not launched by register(): {launches}")

    # ---- 5. training -----------------------------------------------------------
    print("# phase 5: training (run_training, flagship widths)", flush=True)
    with tempfile.TemporaryDirectory() as td:
        train_launches, train_numbers = training_phase(dev, shape, timer, rehearsal, td)
    training = tuple(k.name for k in kernels.KERNELS if k.name not in serving) + ("warp_trilinear",)
    if not rehearsal:
        check(all(train_launches[k] >= 1 for k in training),
              f"a kernel of the training path was not launched by run_training(): {train_launches}")
        # K1 serves the validation steps (no gradient is asked there): one
        # launch each; K3 never runs, the loss does not read `moved`
        check(train_launches["conv3_lrelu_pool"] == 2 and train_launches["warp_up2x"] == 0,
              f"inference-only kernels in run_training, want K1 x2 (validation), K3 x0: "
              f"{train_launches}")

    # ---- 6. report -----------------------------------------------------------
    # launches: of the main path that runs the kernel, counted from zero just
    # before it: register() for K1-K3, run_training() for K4-K7
    report = []
    for k in kernels.KERNELS:
        row = timing[k.name]
        report.append({
            "name": k.name, "route": "cuda",
            "source": f"multimodal_registration_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": launches[k.name] if k.name in serving else train_launches[k.name],
            "launches_register": launches[k.name],
            "launches_run_training": train_launches[k.name],
            "max_abs_err": results[k.name]["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "device_ops": row["device_ops"], "library_device_ms": row["library_device_ms"],
        })
        if "fused" in row:  # K2 and K5: the fused squaring step, timed on its own
            fused = row["fused"]
            report[-1].update({
                "fused_max_abs_err": results[k.name]["fused_max_abs_err"],
                "fused_ms": fused["ms"], "fused_device_ms": fused["device_ms"],
                "fused_device_ops": fused["device_ops"], "fused_plain_ms": fused["plain_ms"],
                "fused_bound_ms": fused["bound"][0], "fused_bound_by": fused["bound"][1],
            })
    print(json.dumps({"kernels": report}))
    print(f"# forward_ms {fwd_ms:.4f} pairs_per_s {1000 / fwd_ms:.4f} peak_mib {peak:.1f} "
          f"train_s_per_step {train_numbers['step_s']:.4f} "
          f"train_peak_mib {train_numbers['train_peak_mib']:.1f} "
          f"total_s {time.time() - t_start:.1f}")
    if rehearsal:
        print("# rehearsal on the CPU: every number above is a CPU number, not a device metric")
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, "nvidia-smi failed")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
