#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py               # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu  # rehearsal: tiny shapes, plain versions

Phases (any failure exits non-zero):
  1. build the hand-written kernels (csrc/*.cu, one nvcc each, in parallel);
  2. hold each of the eight kernels against its plain PyTorch version on the
     card, at the shapes of the flagship forward and of a training step (K1
     also at a ragged shape with batch 2, at 256 output channels, in float32
     and, F12, the w256 first level at 192^3 with batch 2; K8, the int8
     conv, at a ragged shape here and at the published widths' shapes in
     phase 7; K2 and K5 also through their fused squaring step: forward exact,
     backward, the 5-step integration and its device launches; K6 and K7 also
     through their Dice entries, the training loss's fused Dice: the sums and
     the flow gradient against their plain versions, the fused loss against
     the dense path (the plain versions, and K6 + K7) at 160x160x192 with 26
     labels, both zeropad settings, each entry's time beside its bounds, and
     the dense path's device time and peak memory beside the fused one's),
     and check that the inference-only kernels refuse to be differentiated;
  3. the flagship forward (VxmDense enc [64]x4 / dec [64]x6, int_steps 5,
     svf_res = int_res = 2, bf16) on the in-repo checkpoint at
     (1, 160, 160, 192, 1): kernel path against the plain path, launch
     counts per forward (K10 x3, K11 x9 among them), ms per forward, pairs/s, peak memory, and each
     kernel's wrapper time, device time and device operations per call
     beside its bound, its plain version and a PyTorch yardstick that the
     port never calls;
  4. ``register()`` end to end on a synthetic 1 mm NIfTI pair of that size;
  5. training: one loss-and-backward of the flagship model at full width on
     a fixed synthesised batch, through the kernels against the same through
     their plain versions; then ``run_training`` (label maps generated on the
     card, 26 labels, 160x160x192, batch 1) for 4 steps with the pool
     adjoint's tie rule ``equal`` and one with ``first``: launch counts per
     step (the loss's Dice through K6's and K7's Dice entries), s/step, peak
     memory, a profile, and each training kernel's time beside its bound, its
     plain version and a PyTorch yardstick;
  6. inference on real-scan layouts, at the flagship widths on the in-repo
     checkpoints, each through the kernels (launches counted) and through
     their plain versions (``impl="plain"``), the files written and finite:
     6a. ``register()`` of an axis-aligned anisotropic pair (fixed 200x200x160
         at 0.8x0.8x1.2 mm, moving 256x256x96 at 0.625x0.625x2 mm, the same
         field of view): the separable device spline, held against scipy;
     6b. the same moving scan rotated 6 degrees about z and shifted 2 mm: the
         oblique linear preprocessing and the oblique cubic spline;
     6c. ``use_subvol`` (tiles of 80x80x96, batches of 4) on the phase-4
         pair through ``Registrar.register_tensors``, its launches those the
         registrar states, and the blend's time;
     6d. ``bids_two_steps`` through its argv on 6b's pair (model 1
         ``learned_model1``, model 2 ``learned_ref``, composition on the
         image grid), and the composition's time;
     6e. the three evaluators on 6b's and 6d's outputs, on the device
         against the same on the CPU;
  7. the published inference widths (``config/config_inference.json``: enc
     [256]x4, dec [256]x6) on the in-repo checkpoint
     ``learned_w256_160x160x192_26lab.npz``, on phase 4's pair:
     7a. kernel K8 (the int8 conv) at every int8 conv shape of that forward
         and a ragged one, int32 sums and outputs equal to its plain
         version's, timed beside its bound, its plain version and cuDNN's bf16
         conv (a yardstick the port never calls);
     7b. the forward in bf16 (K1, K2 x5, K3; cuDNN for the other convs);
     7c. the forward in int8 with the in-repo sidecar (K8 on 9 convs), and
         what int8 costs against 7b;
     7d. ``register()`` with the published config and ``quantize: "int8"``:
         the lazy calibration writes a sidecar into a temp directory, the
         ``quant-calibrate`` command another one; they agree, and nothing is
         written under ``benchmarks/``;
  8. the BIDS batch pipeline at the published widths on the in-repo w256
     checkpoint, over three subjects (one with a session; T2w at 6a's fixed
     layout, T1w at its moving layout):
     8a. ``run_batch`` with write-behind saves and the native prefetch:
         s/subject, timings by phase, the device's idle share;
     8b. the same subjects through a loop of ``run_subject``, synchronous
         writes: s/subject, and the output tree equal to 8a's byte for byte
         but for the times of writing;
     8c. one subject with the opt-affine fallback forced: the affine warp
         (K2) against its plain version;
     8d. one subject in int8 with the in-repo sidecar (K8 in the pipeline)
         against ``register()`` through the plain versions; nothing under
         ``benchmarks/`` changes;
     8e. the native NIfTI reader and gzip writer against the Python ones on
         the largest output file, in MB/s, the arrays equal;
  9. the port's training learns (``tools/learn_check.py``), budget 180 s:
     9a. the flagship model trained from scratch at 96^3, 16 labels, 1000
         steps (the svf4 probe's configuration at ``TrainConfig``'s
         ``svf_int_res``), held-out Dice and NMI after them:
         both above the identity's at the end, and the mean loss of the last
         200 steps below that of the first 200;
     9b. a warm start from ``learned_ref_160x160x192_26lab.npz`` at
         160x160x192, 26 labels, 300 steps: above the identity at step 0, and
         Dice within 0.01 of step 0's after; nothing under ``benchmarks/``
         changes;
     9c. ``device_trace`` around three of 9a's training steps: the trace
         names the kernels of K2, K4, K5, K6 and K7, and the launches per step;
 10. multi-GPU (item 15), budget 120 s, on a mesh of distinct cards where
     there are enough and of ``cuda:0`` repeated otherwise (the slabs and
     replicas are split and their halos copied all the same; one card shows
     the sharding's overhead, not a speed-up):
     10a. the flagship forward through ``ShardedRegistrar`` ``{space: 2}``
          against the single-device ``Registrar`` (the F2 rule), launches
          per forward (K1 x2, K2 x5, K3), ms, peak memory, the device time of
          the sharding;
     10b. ``{data: 2}`` on a batch of 3 (padded) and ``{data: 2, space: 2}``
          on a batch of 2;
     10c. the published widths in int8 with the in-repo sidecar, ``{space:
          2}`` (K8 on 9 convs of 2 slabs), and the lazy calibration over
          slabs against one device's;
     10d. ``pair_registration`` and ``bids_two_steps`` through their argv with
          ``--space 2`` against the same without it; ``make_registrar``
          refuses more devices than there are;
     10e. data-parallel training at full width (26 labels, batch 2, ``{data:
          2}``): a step against the 1-device step, then ``run_training`` with
          ``num_devices`` 2 for 2 steps;
 11. the bench, budget 90 s:
     11a. ``bench_torch.py`` with its default flags, in a process of its own:
          exit code 0 and exactly three JSON lines on stdout, infer256 bf16,
          infer256 int8, train64 (``bench.py``'s metric names, keys and
          order), each value > 0; its launches (K1 x1, K2 x5, K3 x1, K10 x3,
          K11 x9 a forward, K8 x9 and K11 x0 in int8); then the kernels at its 192^3 shapes and
          its three models through them, against their plain versions;
     11b. the w256 checkpoint in int8 (lazily calibrated on the first pair)
          against bf16 on three held-out pairs at 160x160x192, 26 labels
          (``tools/learn_check.py``): int8's Dice at most 0.005 and its NMI
          at most 0.002 below bf16's (the JAX package's gate,
          ``benchmarks/quantize_quality_probe.py``), and the flow agreement;
 12. the pipeline's registration quality on held-out synthetic subjects
     (``tools/pipeline_quality.py``), budget 240 s:
     12a. ``run_batch`` with ``--opt-affine`` (min SC-Dice 80) on three
          subjects of new label maps (160x160x192, 26 labels, a brightened
          "cord" label) in three arms: ``learned_ref``, the w256 checkpoint
          in bf16 and in int8 (the in-repo sidecar); K1, K2, K3 (K8 in int8)
          launched in each arm; sub-01 again through the plain versions
          (phase 3's limits, the gate's folding); gates: SC-Dice after
          >= 0.80, NMI gain > 0 and folding <= 0.1 % for every subject, no
          fallback, int8's mean within 0.005 of bf16's;
     12b. a second tree with the moving contrast rigidly displaced, in five
          arms (single, opt_affine, opt_affine_rigid, two_step,
          two_step_smooth): the cascade above the single model, its
          smoothed folding at most its raw folding;
 13. the training step's and the pipeline's measurement tools
     (``multimodal_registration_torch/tools/``), budget 180 s:
     13a. ``train_bench`` in processes of their own (``--iters 6 --blocks
          3``): the flagship at batch 1 and 2, enc/dec 256 at batch 1; each
          step's launches as counted, a finite final loss at most 0.02 above
          the warm-up step's, the peak memory; the w256 step's fixed batch
          through the kernels against the plain versions (phase 5's check);
          K4 at 256 channels on the full grid and each level below against
          its plain version, exactly, with its time and bound;
     13b. ``train_breakdown`` and ``train_profile`` (3 steps) for the
          flagship and enc/dec 256, ``bwd_breakdown``, ``synth_breakdown``
          and ``train_sol`` at 160x160x192, 26 labels, with their default
          iterations, ``fwd_breakdown`` at 192^3 for ``train`` and
          ``infer256``: every measured row finite and positive, every
          derived row finite, each full step within 25 % of 13a's s/step of
          its widths, each profile naming K2, K4, K5, K6 and K7;
     13d. ``pipeline_throughput --subjects 3 --configs
          default,noprefetch,jobs2``: every subject ok, subjects/min;
 14. the studies ``benchmarks/`` held only in JAX, through the port's tools
     (``multimodal_registration_torch/tools/``), budget 180 s (held on the
     card), ``benchmarks/`` hashed before and after, nothing caught:
     14a. ``ablate`` at 192^3: four positive rows; launches per chain call:
          K1 x1, K10 x3, K11 x9 (the U-Net, no gradient), K2's fused step x5 (integrate), K2
          x1 (warp), none (rescale);
     14b. ``unet_bwd_probe 6`` at 160x160x192: five sections, each with
          finite positive ``_fwd_ms`` and ``_fwd_bwd_ms`` and no ``_error``;
          K4 launches 4 in a forward and backward of ``unet_full``, 1 of
          ``first_convrpool``, none of ``first_convpool`` (``F.max_pool3d``);
     14c. ``learn_ref_workload``, two legs in one temp ``--out-dir``: 200
          steps warm from ``learned_ref`` (a fresh log), then 100 resuming
          its own checkpoint: steps 0, 200, 300; step 0's Dice and NMI above
          the identity's; Dice at step 300 within 0.01 of step 0's;
     14d. ``learn_ref_workload --width 256``, 20 steps warm from the w256
          checkpoint: a finite loss, step 0 above the identity;
     14e. ``learn_model1_workload 200`` warm from ``learned_model1``: step 0's
          Dice above the identity's in both regimes (``smooth``, ``affine``),
          the ``smooth`` Dice at step 200 within 0.01 of step 0's;
     14f. ``cascade_folding_probe`` then ``cascade_smoothing_sweep`` on sub-02
          at 160x160x192: every value finite, the numpy compose's folding
          within 0.01 points of ``compose_fields``', step 1's folding at
          sigma 1.5 and 3 at most sigma 0's, the int compose's Dice at every
          sigma at least sigma 0's less 0.01;
     14g. ``opt_affine_rotation_study``: every Dice within 0.002 and every
          angle within 0.05 degree of ``benchmarks/opt_affine_rotation_results.json``,
          the summary's booleans equal;
 15. the last probes ``benchmarks/`` held only in JAX and the port's
     ``entry()``, budget 150 s (held on the card), ``benchmarks/`` hashed
     before and after, nothing caught:
     15a. ``svf4_learn_probe 1000``: the flagship model trained from scratch
          at 96^3, 16 labels, in two arms, the synthesis integrating at
          ``svf_int_res`` 2 and at 4 (the two configurations differ in that
          only), evaluated at step 1000 on the same three held-out pairs (the
          same tensors): each arm's Dice and NMI above the identity's; the gap
          between the arms printed, not held; arm 4's trained forward
          through the kernels against their plain versions (phase 3's limits);
     15b. ``conv_probe``: the seven conv cases of the JAX script on cuDNN in
          bf16, each ms > 0 and 0 < TFLOP/s <= 989 (the bf16 peak), its share
          of the peak printed; none of the port's kernels launched;
     15c. ``pair_interleave_probe`` at 192^3: the guard (the staged U -> T
          against ``model(...)`` at 64^3), then on the in-repo ``learned_ref``
          weights each two-pair arm's ``moved`` and ``warp`` against the
          single pair's (the F2 rule; bit for bit printed), K1 x1, K2's fused
          step x5, K3 x1, K10 x3, K11 x9 a pair (a call for the batch of 2); the probe's rows
          (its own initial weights) every one > 0; the two-stream speedup
          printed, not held;
     15d. ``entry()``: ``fn(*example_args)`` gives (1, 160, 160, 192, 1) and
          (1, 80, 80, 96, 3), finite, through K1 x1, K2 x5, K3 x1, K10 x3, K11 x9; with the
          in-repo ``learned_ref`` weights in ``params``, ``fn`` on phase 3's
          pair equals phase 3's forward bit for bit;
 16. K9, the flow head's float32 conv C -> 3 (forward, input gradient, weight
     and bias gradients), at the flagship and published widths (80x80x96, C 64
     and 256), the tiles of use_subvol (4 x 40x40x48) and one {space: 2} slab
     with its halo: each entry against its plain version in float64 (each
     element within 4 sqrt(N) 2**-24 of the root of its N squared terms, the
     bf16 input gradient also 1 bf16 ulp; bf16-rounded terms seen beyond
     it), twice the same bits;
     each entry's ms, device ms and bound beside its plain version and the
     library conv it replaced; K9 x1 a flagship forward, each entry once a
     loss-and-backward;
 17. K10, the U-Net decoder's nearest 2x upsample and skip concatenation, at
     the three levels of a flagship and of a w256 forward (64 and 256
     channels, bf16): each launch equal to its plain version bit for bit; a
     pair's three launches timed beside their byte bound, the plain version
     and ``F.interpolate`` + ``torch.cat``, the composition K10 replaced;
 18. K11, the library convs' bias and LeakyReLU in place, at each library
     conv's output shape of a flagship and of a w256 forward (64 and 256
     channels, bf16 and float32): each launch equal bit for bit to its plain
     version and to the library's ``add_`` + ``F.leaky_relu`` it replaced;
     each bf16 level timed beside its byte bound, the plain version and that
     composition, and a pair's nine launches summed;
 19. the report, and the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``; it is printed only on
the card and only when every phase passed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "benchmarks", "learned_ref_160x160x192_26lab.npz")
CKPT_MODEL1 = os.path.join(HERE, "benchmarks", "learned_model1_160x160x192_26lab.npz")
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
    as often per call as it was seen, rounded. Late in a long run a window
    has come back with no device record at all (K4 at 256 channels, 14 calls
    of 2 ms, after phases 1-12): such a window is taken again, up to twice,
    each time four times as long."""
    import torch

    if not torch.cuda.is_available():
        return None, None, []
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = min(1000, max(n, int(0.03 / max(time.perf_counter() - t0, 1e-6))))
    for attempt in range(3):
        events, _ = _profiled(fn, n)
        if events:
            break
        print(f"#   the profiler recorded no device time for {what or fn} in {n} calls "
              f"(window {attempt + 1} of 3)", flush=True)
        n *= 4
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
        return {}
    idle = max(0.0, 1 - busy_ms / wall_ms)
    print(f"#   profile ({n} {what}s): device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"per {what} in {sum(e.count for e in events) / n:.0f} device operations, "
          f"idle share {idle:.3f}")
    for e in sorted(events, key=_dev_us, reverse=True)[:top]:
        print(f"#     {_dev_us(e) / 1e3 / n:9.4f} ms  x{round(e.count / n):<3d} {e.key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle_share": idle}


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


def corner_label_reads(labels, flow, num_classes):
    """What K7's function must read of its cotangent ``g (1, X, Y, Z, L)`` for
    the warp of ``labels (1, X, Y, Z)`` by ``flow``: ``(entries, sectors)``.
    ``entries`` is the sum over voxels of the number of distinct labels among
    the 8 corners; ``sectors`` the number of distinct 32-byte sectors of ``g``
    those entries lie in (entry ``n * L + label`` of float32 lies in sector
    ``(n * L + label) // 8``). The card reads device memory in whole sectors,
    so the sectors, not the entries, are the bytes that must move."""
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
    srt = torch.stack(corner, -1).sort(dim=-1).values.long()
    entries = int((srt[..., 1:] != srt[..., :-1]).sum()) + X * Y * Z
    voxel = torch.arange(X * Y * Z, device=flow.device).reshape(X, Y, Z, 1)
    sectors = torch.unique((voxel * num_classes + srt) // 8).numel()
    return entries, sectors


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
    row["device_ms"], row["device_ops"], row["device_rows"] = device_time(call, f"{name} call")
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


# the report's rows of the Dice entries of K6 and K7, by their C entries
DICE_ENTRIES = {"warp_labels_dice_fwd": "warp_labels_dice_fwd_launch",
                "warp_labels_dice_bwd": "warp_labels_dice_bwd_launch"}


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
    # what this run's labels and flow need, not all L entries of every voxel,
    # and count it in the 32-byte sectors that the card moves
    needed, sectors = corner_label_reads(labels, lflow, L)
    print(f"#   K7 reads {needed / nfull:.3f} cotangent entries per voxel of {L} "
          f"(distinct corner labels), which lie in {sectors / nfull:.3f} 32-byte sectors per "
          f"voxel: {32 * sectors / 1e6:.1f} MB must move, not the {4 * needed / 1e6:.1f} MB of "
          "the entries alone")
    timing["warp_labels_bwd"] = measure(
        timer, "warp_labels_bwd",
        bound(32 * sectors + nfull * (1 + 12 + 12), nfull * 80, FP32_FLOPS),
        backward_call(lambda f: warp_onehot_batch(labels, f, L), [lflow], lcot),
        backward_call(lambda f: warp_onehot_batch(labels, f, L, impl="plain"), [lflow], lcot),
        plain_kw={"n": 2, "reps": 3})
    # the row keeps both bounds: the sectors are what this layout of g (labels
    # innermost, 104 bytes a voxel) makes the card move, the entries what the
    # function needs and a label-major cotangent could come down to
    timing["warp_labels_bwd"]["bound_needed"] = bound(
        4 * needed + nfull * (1 + 12 + 12), nfull * 80, FP32_FLOPS)
    print(f"#   K7 bound {timing['warp_labels_bwd']['bound'][0]:.4f} ms by the sectors moved, "
          f"{timing['warp_labels_bwd']['bound_needed'][0]:.4f} ms by the entries needed")
    dice_phase(dev, shape, timer, results, timing, labels, lflow, L, gen, needed, sectors)


def rel_err(name, got, ref, tol):
    """``|got - ref| / |ref|`` of two scalars, printed and held to ``tol``."""
    got, ref = float(got), float(ref)
    err = abs(got - ref) / max(abs(ref), 1e-30)
    print(f"#   {name}: {got:.8f} against {ref:.8f}, relative error {err:.3e} (tolerance "
          f"{tol:.0e}) {'ok' if err <= tol else 'FAILED'}", flush=True)
    check(err <= tol, f"{name} disagrees")
    return err


def dice_phase(dev, shape, timer, results, timing, labels, lflow, L, gen, needed, sectors):
    """Phase 2, the training loss's Dice pair: K6's Dice entry (the sums I,
    P, T of each label, without the warped map) and K7's (the flow gradient,
    its cotangent formed in the kernel) against their plain versions, and
    ``warp_onehot_dice_batch`` against the dense composition through the
    plain versions (``impl="plain"``) and through K6 and K7, at the phase's
    labels and field; the target t is K6's soft warp of a second label map
    under a second smooth field. Loss within 1e-5 relative (sums over the
    volume in another order), flow gradients within 1e-5 of their largest
    entry, both zeropad settings. Then each entry's time beside its bound,
    the dense path's device time on the same inputs, and each path's peak
    memory above its inputs."""
    import torch

    from multimodal_registration_torch.losses import dice_loss, dice_loss_zeropad
    from multimodal_registration_torch.ops.warp import (
        dice_coefficients, warp_labels_dice_flow_grad, warp_labels_dice_sums, warp_onehot_batch,
        warp_onehot_dice_batch)

    nfull = math.prod(shape)
    coarse = torch.randint(0, L, (1, *(max(s // 8, 1) for s in shape)), generator=gen,
                           device=dev, dtype=torch.uint8)
    labels2 = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2).repeat_interleave(8, 3)
    labels2 = labels2[:, :shape[0], :shape[1], :shape[2]].contiguous()
    with torch.no_grad():
        t = warp_onehot_batch(labels2, smooth_field(shape, 3.0, 8, dev), L)
    del labels2
    errs_f, errs_b = [], []
    for zeropad in (False, True):
        zp = f"zeropad {str(zeropad).lower()}"
        sums = warp_labels_dice_sums(labels, lflow, t, L, zeropad)
        psums = warp_labels_dice_sums(labels, lflow, t, L, zeropad, impl="plain")
        loss, coef = dice_coefficients(sums, zeropad)
        ploss, pcoef = dice_coefficients(psums, zeropad)
        rel_err(f"K6 warp_labels_dice_fwd, {zp}: the loss from its sums", loss, ploss, 1e-5)
        errs_f.append(abs(float(loss) - float(ploss)))
        srel = float(((sums - psums).abs() / psums.abs().clamp(min=1.0)).max())
        print(f"#   K6 warp_labels_dice_fwd, {zp}: sums max relative error {srel:.3e}")
        gk = warp_labels_dice_flow_grad(labels, lflow, t, pcoef, L, zeropad)
        gp = warp_labels_dice_flow_grad(labels, lflow, t, pcoef, L, zeropad, impl="plain")
        m = float(gp.abs().max())
        check(m > 0, f"K7 warp_labels_dice_bwd, {zp}: the plain gradient is zero")
        errs_b.append(compare(f"K7 warp_labels_dice_bwd, {zp}: grad flow (max {m:.3e})", gk, gp,
                              1e-5 * m))
        del gk, gp
        # the function against the dense path, through the plain versions and
        # through K6 and K7
        dense = dice_loss_zeropad if zeropad else dice_loss
        sides = {}
        for name, fn in (
            ("fused", lambda f: warp_onehot_dice_batch(labels, f, t, L, zeropad)),
            ("dense, plain", lambda f: warp_onehot_dice_batch(labels, f, t, L, zeropad,
                                                              impl="plain")),
            ("dense, K6 + K7", lambda f: dense(t, warp_onehot_batch(labels, f, L))),
        ):
            f = lflow.clone().requires_grad_()
            d = fn(f)
            d.backward()
            sides[name] = (d.detach(), f.grad)
            del d, f
        d, g = sides.pop("fused")
        for name, (dp, gp) in sides.items():
            rel_err(f"warp_onehot_dice_batch, {zp}, against the {name} path: loss", d, dp, 1e-5)
            m = float(gp.abs().max())
            compare(f"warp_onehot_dice_batch, {zp}, against the {name} path: grad flow "
                    f"(max {m:.3e})", g, gp, 1e-5 * m)
        del sides, d, g
    results["warp_labels_dice_fwd"] = {"max_abs_err": max(errs_f)}
    _, coef = dice_coefficients(warp_labels_dice_sums(labels, lflow, t, L), False)
    results["warp_labels_dice_bwd"] = {"max_abs_err": max(errs_b)}

    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    # the forward reads all of t (T needs every entry), the flow and the labels
    timing["warp_labels_dice_fwd"] = measure(
        timer, "warp_labels_dice_fwd",
        bound(nfull * (1 + 12 + 4 * L), nfull * (40 + 8 * L), FP32_FLOPS),
        no_grad(lambda: warp_labels_dice_sums(labels, lflow, t, L)),
        no_grad(lambda: warp_labels_dice_sums(labels, lflow, t, L, impl="plain")),
        plain_kw={"n": 2, "reps": 3})
    # the backward reads of t what K7 reads of its cotangent, in the same layout
    timing["warp_labels_dice_bwd"] = measure(
        timer, "warp_labels_dice_bwd",
        bound(32 * sectors + nfull * (1 + 12 + 12), nfull * 80, FP32_FLOPS),
        no_grad(lambda: warp_labels_dice_flow_grad(labels, lflow, t, coef, L)),
        no_grad(lambda: warp_labels_dice_flow_grad(labels, lflow, t, coef, L, impl="plain")),
        plain_kw={"n": 2, "reps": 3})
    timing["warp_labels_dice_bwd"]["bound_needed"] = bound(
        4 * needed + nfull * (1 + 12 + 12), nfull * 80, FP32_FLOPS)
    print(f"#   K7 warp_labels_dice_bwd bound {timing['warp_labels_dice_bwd']['bound'][0]:.4f} ms "
          f"by the sectors of t moved, "
          f"{timing['warp_labels_dice_bwd']['bound_needed'][0]:.4f} ms by the entries needed")

    # the loss's forward and backward, fused against dense (K6, dice_loss, its
    # backward, K7), as a training step runs them: device time and operations
    def step_of(fn):
        def call():
            f = lflow.detach().requires_grad_()
            d = fn(f)
            torch.autograd.grad(d, f)
        return call

    paths = {"fused": step_of(lambda f: warp_onehot_dice_batch(labels, f, t, L)),
             "dense": step_of(lambda f: dice_loss(t, warp_onehot_batch(labels, f, L)))}
    yard = {}
    for name, call in paths.items():
        row = {"ms": timer(call, n=5)}
        row["device_ms"], row["device_ops"], _ = device_time(
            call, f"Dice loss forward + backward, {name}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            row["peak_extra_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        yard[name] = row
    soft_mib = nfull * L * 4 / 2**20
    print(f"#   Dice loss forward + backward ({'x'.join(map(str, shape))}, {L} labels): "
          + "; ".join(f"{k} {v['ms']:.4f} ms wrapper, {v['device_ms']} ms device in "
                      f"{v['device_ops']} operations, peak {v.get('peak_extra_mib', float('nan')):.1f}"
                      f" MiB above its inputs" for k, v in yard.items())
          + f"; one soft map is {soft_mib:.1f} MiB", flush=True)
    if dev.type == "cuda":
        check(yard["fused"]["peak_extra_mib"] < 0.25 * soft_mib,
              f"the fused Dice allocated {yard['fused']['peak_extra_mib']:.1f} MiB: a soft map "
              f"or its cotangent ({soft_mib:.1f} MiB) was formed")
    timing["warp_labels_dice_bwd"]["paths"] = yard


def fixed_batch(trainer, shape):
    """Two label maps of 8^3 blocks and the batch synthesised from them
    (no zero borders), with ``trainer``'s flow head scaled far from zero so
    that every branch of the loss carries signal: ``(maps, batch)``."""
    import torch

    from multimodal_registration_torch.train.trainer import synthesize

    cfg = trainer.cfg
    with torch.no_grad():
        trainer.model.flow.weight.mul_(2000.0)
    coarse = torch.randint(0, cfg.num_labels, (2, *(max(s // 8, 1) for s in shape)),
                           generator=trainer.generator(1), device=trainer.device,
                           dtype=torch.uint8)
    maps = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2).repeat_interleave(8, 3)
    maps = maps[:, :shape[0], :shape[1], :shape[2]].contiguous()
    return maps, synthesize(trainer.generator(2), maps[:1], maps[1:], trainer.engine_cfg, cfg,
                            False)


def fixed_batch_check(label, trainer, batch):
    """One loss and backward of ``trainer``'s model on ``batch`` through the
    kernels and through their plain versions: the loss within 1e-3, each
    parameter's gradient within 0.1 of its largest entry with cosine >= 0.995."""
    import numpy as np

    from multimodal_registration_torch.models.weights import grads_to_jax
    from multimodal_registration_torch.train.trainer import loss_from_batch

    sides = {}
    for impl in (None, "plain"):
        trainer.optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_from_batch(trainer.model, batch, trainer.engine_cfg, trainer.cfg, False,
                                  impl)
        loss.backward()
        sides[impl] = (float(loss.detach()), grads_to_jax(trainer.model))
    (lk, gk), (lp, gp) = sides[None], sides["plain"]
    # both sides run the same cuDNN convs; they differ where K5 sums the
    # bf16 integration's cotangents in float32 (the plain version scatters in
    # bf16), and where cuDNN's backward picks another summation order
    print(f"#   {label}: loss kernels {lk:.6f}, plain {lp:.6f} (tolerance 1e-3)")
    check(abs(lk - lp) <= 1e-3, f"{label}: loss through the kernels disagrees with the plain path")
    worst = 0.0
    for name, ref in gp.items():
        rel = float(np.abs(gk[name] - ref).max() / max(np.abs(ref).max(), 1e-30))
        cos = float((gk[name] * ref).sum()
                    / max(np.linalg.norm(gk[name]) * np.linalg.norm(ref), 1e-30))
        worst = max(worst, rel)
        check(np.isfinite(gk[name]).all() and np.abs(ref).max() > 0,
              f"{label}: gradient of {name} is not finite or zero")
        check(rel <= 0.1 and cos >= 0.995,
              f"{label}: gradient of {name}: kernels vs plain max diff {rel:.3e} of max, cosine {cos:.5f}")
    print(f"#   {label}: {len(gp)} parameter gradients, worst max-diff {worst:.3e} of the "
          "leaf's max (tolerance 0.1, cosine >= 0.995)", flush=True)


def training_phase(dev, shape, timer, rehearsal, tmp):
    """Phase 5: the flagship model's training at full width. Returns
    ``(launches of the run_training run, numbers to print)``."""
    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.train.cli import run_training
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import Trainer

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
    maps, batch = fixed_batch(trainer, shape)
    fixed_batch_check("fixed batch", trainer, batch)
    del trainer, batch

    # -- run_training, the entry point a user calls: 4 steps, tie "equal"
    kernels.reset_launch_counts()
    out = run_training(cfg, max_steps=4, device=dev, pool_tie="equal")
    launches = kernels.launch_counts()
    entries = kernels.entry_launch_counts()
    print(f"#   launches in run_training (label maps, 4 steps, 2 validation steps): {launches}; "
          f"by entry {entries}")
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
    step_entries = kernels.entry_launch_counts()
    want = trainer.step_launches()
    print(f"#   launches per training step: {per_step}; by entry {step_entries}")
    if not rehearsal:
        check(per_step == want, f"a step launched {per_step}, want {want}")
        # the loss's Dice through K6's and K7's Dice entries; K7's general
        # entry (a dense cotangent) no more
        check(step_entries.get("warp_labels_dice_fwd_launch") == 1
              and step_entries.get("warp_labels_dice_bwd_launch") == 1
              and "warp_labels_bwd_launch" not in step_entries,
              f"a step's Dice did not run through the Dice entries: {step_entries}")
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
    return launches, {"step_s": step_ms / 1e3, "train_peak_mib": peak, "entries": entries,
                      "step_launches": want}


def forward_launches(settings: dict) -> dict:
    """``VxmDense.kernel_launches`` of the model that an inference config's
    ``settings`` build, read off a copy on the meta device."""
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import vxm_config_from
    from multimodal_registration_torch.models.vxm_dense import VxmDense

    cfg = vxm_config_from(InferenceConfig.from_dict(dict(settings)))
    return VxmDense(cfg, device="meta").kernel_launches()


def scan_affine(shape, voxel, rot_deg=0.0, shift=(0.0, 0.0, 0.0)):
    """Affine of a scan of ``shape`` and ``voxel`` size (mm) whose field of
    view is centred on the origin, rotated about z and shifted (mm)."""
    import numpy as np

    aff = np.diag([*voxel, 1.0])
    aff[:3, 3] = [-(n - 1) * v / 2 for n, v in zip(shape, voxel)]
    c, s = math.cos(math.radians(rot_deg)), math.sin(math.radians(rot_deg))
    rot = np.array([[c, -s, 0.0, 0.0], [s, c, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0], [0, 0, 0, 1.0]])
    aff = rot @ aff
    aff[:3, 3] += shift
    return aff


def tube_scan(shape, affine, seed, shift_mm=0.0):
    """A bright tube along scanner z (1/e at 13.4 mm from its axis, moved
    ``shift_mm`` in x) sampled on the grid ``(shape, affine)`` of an affine
    whose third column is z alone, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    axes = [np.arange(n, dtype=np.float32) for n in shape]
    x = (affine[0, 0] * axes[0][:, None] + affine[0, 1] * axes[1][None, :] + affine[0, 3])[..., None]
    y = (affine[1, 0] * axes[0][:, None] + affine[1, 1] * axes[1][None, :] + affine[1, 3])[..., None]
    tube = np.exp(-((x - shift_mm) ** 2 + y ** 2) / 180.0) * np.ones(shape[2], np.float32)
    return (tube + 0.05 * rng.random(shape, dtype=np.float32)).astype(np.float32)


def finite_files(paths):
    """Check that every path was written and holds finite values."""
    import numpy as np

    from multimodal_registration_torch.utils import nifti

    for p in paths:
        check(os.path.exists(p), f"{p} was not written")
        check(bool(np.isfinite(nifti.load(p).get_fdata()).all()), f"{p} is not finite")


def kernels_vs_plain(label, out_k, out_p):
    """A registration through the kernels against the same through their
    plain versions: the field (voxels), the moved image on the fixed grid and
    on the moving grid (intensities in [0, 1]), PERF.md section 2's limits."""
    import numpy as np

    d_warp = float(np.abs(out_k["warp_data"] - out_p["warp_data"]).max())
    d_moved = float(np.abs(np.asarray(out_k["moved"]) - np.asarray(out_p["moved"])).max())
    d_orig = float(np.abs(out_k["moved_orig"] - out_p["moved_orig"]).max())
    print(f"#   {label}: kernels vs plain: warp {d_warp:.3e} voxel (tol 0.1), moved {d_moved:.3e}, "
          f"moved on the moving grid {d_orig:.3e} (tol 0.05); max|warp| "
          f"{float(np.abs(out_p['warp_data']).max()):.3f}")
    check(d_warp <= 0.1 and d_moved <= 0.05 and d_orig <= 0.05,
          f"{label}: the kernel path disagrees with the plain path")
    return {"d_warp": d_warp, "d_moved": d_moved, "d_moved_orig": d_orig}


def launched(label, counts, want, rehearsal=False):
    """Each kernel that ``want`` launches (a forward's launches,
    ``VxmDense.kernel_launches``) was launched at least once."""
    print(f"#   {label}: launches {counts}")
    if not rehearsal:
        check(all(counts[k] >= 1 for k in counts if want.get(k)),
              f"{label}: a kernel was not launched: {counts}, want {want}")


def spline_phase(label, out, fixed_proc_path, moving_nii, timer, dev, rehearsal):
    """The cubic device spline of the postprocess: the moved image resampled
    onto the moving grid (what ``register()`` wrote) against scipy in float64
    on the host, and the device time of the 4-channel resample."""
    import numpy as np
    import torch
    from scipy.ndimage import affine_transform

    from multimodal_registration_torch.ops.resample import _scaled_permutation, device_spline_resample
    from multimodal_registration_torch.utils import nifti

    M = np.linalg.inv(nifti.load(fixed_proc_path).affine) @ moving_nii.affine
    kind = "oblique" if _scaled_permutation(M[:3, :3]) is None else "separable"
    moved = np.asarray(out["moved"], np.float64)
    t0 = time.perf_counter()
    ref = affine_transform(moved, M[:3, :3], offset=M[:3, 3], output_shape=moving_nii.shape[:3],
                           order=3, mode="constant", cval=0.0)
    scipy_s = time.perf_counter() - t0
    m = float(np.abs(moved).max())
    err = float(np.abs(out["moved_orig"] - ref).max())
    print(f"#   {label}: {kind} cubic spline of the moved image onto the moving grid "
          f"{moving_nii.shape[:3]} vs scipy float64: {err:.3e} (tol {1e-4 * m:.3e} = 1e-4 x "
          f"max|input|); scipy on the host {scipy_s:.3f} s for 1 channel")
    check(err <= 1e-4 * m, f"{label}: the device spline disagrees with scipy")
    vol4 = torch.as_tensor(np.repeat(moved.astype(np.float32)[..., None], 4, -1), device=dev)

    def call():
        with torch.inference_mode():
            return device_spline_resample(vol4, M, moving_nii.shape[:3], "constant", 0.0, 3)

    ms = timer(call, n=1, reps=3, warmup=1)
    dev_ms, ops, _ = device_time(call, f"{kind} spline resample, 4 channels" if not rehearsal else None)
    print(f"#   {label}: {kind} spline resample of 4 channels {tuple(vol4.shape)} -> "
          f"{moving_nii.shape[:3]}: {ms:.3f} ms wall, device "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms in {ops} operations'}")
    return {f"{kind}_spline_ms": ms, f"{kind}_spline_device_ms": dev_ms,
            f"{kind}_spline_vs_scipy": err}

W256_CKPT = os.path.join(HERE, "benchmarks", "learned_w256_160x160x192_26lab.npz")
W256_SIDECAR = W256_CKPT + ".quant.json"
INT8_TENSOR_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
# the int8 convs of the w256 forward at 160x160x192, batch 1: (convs, Cin, Cout, grid)
K8_SHAPES = (
    ("enc_1, final_0, final_1", 256, 256, (80, 80, 96)),
    ("dec_3", 512, 256, (80, 80, 96)),
    ("enc_2", 256, 256, (40, 40, 48)),
    ("dec_2", 512, 256, (40, 40, 48)),
    ("enc_3", 256, 256, (20, 20, 24)),
    ("dec_1", 512, 256, (20, 20, 24)),
    ("dec_0", 256, 256, (10, 10, 12)),
)
K8_RAGGED = ("ragged, batch 2, odd Cout", 200, 75, (2, 21, 19, 13))
PHASE7_BUDGET_S = 60  # of the script's 1200 s; about 35 s on an H100


def k8_inputs(dev, batch_grid, cin, cout, seed):
    """bf16 activations (some beyond the scale 3.0, which clips them), float32
    weights of the size of the checkpoint's and a bias."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(*batch_grid, cin)).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.normal(scale=0.02, size=(cout, cin, 3, 3, 3)).astype(np.float32),
                        device=dev)
    b = torch.as_tensor(rng.normal(scale=0.1, size=(cout,)).astype(np.float32), device=dev)
    return x.bfloat16(), w, b, 3.0


def k8_check(label, x, w, b, amax, plain_device=None):
    """K8 against its plain version: the int32 sums and the outputs, equal.
    With ``plain_device`` the plain version runs on copies of the inputs
    there."""
    import torch

    from multimodal_registration_torch.ops.conv_int8 import conv3_int8

    with torch.inference_mode():
        px, pw, pb = (t.to(plain_device or t.device) for t in (x, w, b))
        same_sums = torch.equal(
            conv3_int8(x, w, b, amax, sums=True),
            conv3_int8(px, pw, pb, amax, impl="plain", sums=True).to(x.device))
        out_k = conv3_int8(x, w, b, amax)
        out_p = conv3_int8(px, pw, pb, amax, impl="plain").to(x.device)
    err = float((out_k.float() - out_p.float()).abs().max())
    print(f"#   K8 conv3_int8 {label} {tuple(x.shape)} -> {w.shape[0]}: int32 sums "
          f"{'equal' if same_sums else 'DIFFER'}, outputs max_abs_err {err:.3e} (exact) "
          f"{'ok' if same_sums and err == 0.0 else 'FAILED'}", flush=True)
    check(same_sums and torch.equal(out_k, out_p), f"K8 {label} disagrees with its plain version")
    return err


def k8_build_report():
    """What ``nvcc -Xptxas -v`` said of K8's conv kernel (registers, spills,
    any wgmma serialisation), and what the runtime reports of it."""
    import ctypes

    from multimodal_registration_torch import kernels

    log = kernels.BUILD_LOG.get("conv_int8.cu", {}).get("log", "")
    lines, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "conv3_int8_wgmma_kernel" in line
        if inside and ("registers" in line or "spill" in line) or "serializ" in line.lower():
            lines.append(line.strip())
    attrs = (ctypes.c_int * 5)()
    kernels.CONV3_INT8.launch_entry("conv3_int8_attributes", ctypes.addressof(attrs), count=False)
    regs, local, static, dynamic, threads = list(attrs)
    print(f"#   K8 conv3_int8_wgmma_kernel, ptxas: {' | '.join(lines) or log[:200]}")
    print(f"#   K8 conv3_int8_wgmma_kernel: {regs} registers a thread, {local} bytes of local "
          f"memory (spills), {static} + {dynamic} bytes of shared memory, {threads} threads a "
          f"block", flush=True)
    return {"registers": regs, "local_bytes": local, "smem_bytes": static + dynamic,
            "ptxas": lines}


def k8_phase(dev, timer, rehearsal):
    """7a: K8 at every int8 conv shape of the w256 forward and a ragged one,
    against its plain version (exact), timed beside its bound, its plain
    version and cuDNN's bf16 conv + LeakyReLU (the yardstick the port never
    calls); the conv kernel's registers, spills and shared memory. Returns
    the row of each shape."""
    import torch
    import torch.nn.functional as F

    from multimodal_registration_torch.ops.conv_int8 import conv3_int8, padded_cin

    rows = []
    for label, cin, cout, grid in K8_SHAPES + (K8_RAGGED,):
        bg = grid if len(grid) == 4 else (1, *grid)
        if rehearsal:
            bg = (bg[0], *(max(2, g // 8) for g in bg[1:]))
        x, w, b, amax = k8_inputs(dev, bg, cin, cout, cin + cout + bg[1])
        k8_check(label, x, w, b, amax)
        vox = math.prod(bg)
        ops = 2 * vox * cout * 27 * cin
        b_k8 = bound(vox * cin * 2 + w.numel() * 4 + b.numel() * 4 + vox * cout * 2, ops,
                     INT8_TENSOR_OPS)
        xc = x.permute(0, 4, 1, 2, 3)
        wb, bb = w.bfloat16(), b.bfloat16()

        def inference(fn):
            def call():
                with torch.inference_mode():
                    return fn()
            return call

        row = measure(timer, f"conv3_int8 {label}", b_k8,
                      inference(lambda: conv3_int8(x, w, b, amax)),
                      inference(lambda: conv3_int8(x, w, b, amax, impl="plain")),
                      inference(lambda: F.leaky_relu(F.conv3d(xc, wb, bb, padding=1), 0.2)),
                      plain_kw={"n": 1, "reps": 1, "warmup": 1})
        # the quantize pass alone: bf16 x read, int8 xq (Cin padded to Cp) written
        b_q = bound(vox * cin * 2 + vox * padded_cin(cin), 0, INT8_TENSOR_OPS)
        by_op = {key: ms for ms, _, key in row.pop("device_rows")}
        q_ms = sum(ms for key, ms in by_op.items() if "quantize_act" in key)
        conv_ms = sum(ms for key, ms in by_op.items() if "conv3_int8" in key)
        row.update(label=label, shape=list(bg), cin=cin, cout=cout, ops=ops,
                   conv_device_ms=conv_ms, quantize_device_ms=q_ms, quantize_bound_ms=b_q[0])
        if row["device_ms"] is None:
            dev_ms = "device n/a"
        else:
            dev_ms = (f"{row['device_ms']:.4f} ms device ({conv_ms:.4f} conv + {q_ms:.4f} "
                      f"quantize, its bound {b_q[0]:.4f} by bytes) = "
                      f"{row['device_ms'] / b_k8[0]:.2f}x bound, "
                      f"{row['device_ms'] / row['library_device_ms']:.3f}x cuDNN bf16")
        print(f"#   K8 {label} {bg} {cin}->{cout}: {row['ms']:.4f} ms wrapper, {dev_ms}, in "
              f"{row['device_ops']} operations, {ops / 1e12:.3f} Tops, bound "
              f"{b_k8[0]:.4f} ms ({b_k8[1]}), plain {row['plain_ms']:.2f} ms, cuDNN bf16 "
              f"{row['library_ms']:.4f} ms ({row['library_device_ms'] or float('nan'):.4f} "
              f"device)", flush=True)
        rows.append(row)
        del x, w, b, xc, wb, bb
    return rows


def w256_forward(label, model, mov_t, fx_t, timer, rehearsal):
    """7b/7c: one forward of the w256 model through the kernels (its launches
    ``model.kernel_launches()``) against the same through their plain
    versions, then ms per forward, pairs/s, peak memory and a profile."""
    import torch

    from multimodal_registration_torch import kernels

    with torch.inference_mode():
        kernels.reset_launch_counts()
        out_k = model(mov_t, fx_t)
        counts = kernels.launch_counts()
        got = {**counts, **kernels.entry_launch_counts()}
        out_p = model(mov_t, fx_t, impl="plain")
    print(f"#   {label}: launches per forward {got}")
    want = model.kernel_launches()
    if not rehearsal:
        check(got == want, f"{label}: the forward launched {got}, want {want}")
    for k in ("moved", "warp"):
        check(bool(torch.isfinite(out_k[k]).all()), f"{label}: {k} not finite")
    shape = tuple(mov_t.shape[1:4])
    check(tuple(out_k["warp"].shape) == (1, *(s // 2 for s in shape), 3),
          f"{label}: warp has the wrong shape")
    d_warp = float((out_k["warp"] - out_p["warp"]).abs().max())
    d_moved = float((out_k["moved"] - out_p["moved"]).abs().max())
    print(f"#   {label}: kernels vs plain: warp {d_warp:.3e} voxel (tol 0.1), moved "
          f"{d_moved:.3e} (tol 0.05); max|warp| {float(out_p['warp'].abs().max()):.3f}")
    check(d_warp <= 0.1 and d_moved <= 0.05, f"{label}: the kernel forward disagrees with the plain one")
    del out_p

    def one_forward():
        with torch.inference_mode():
            model(mov_t, fx_t)

    if mov_t.is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ms = timer(one_forward, n=1, reps=8, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**20 if mov_t.is_cuda else float("nan")
    with torch.inference_mode():
        plain_ms = timer(lambda: model(mov_t, fx_t, impl="plain"), n=1, reps=1, warmup=0)
    print(f"#   {label}: {ms:.3f} ms per forward (median of 8, "
          f"{'CUDA events' if mov_t.is_cuda else 'host clock, CPU'}), {1000 / ms:.3f} pairs/s, "
          f"peak memory {peak:.1f} MiB; through the plain versions {plain_ms:.1f} ms", flush=True)
    prof = {} if rehearsal else profile_calls(one_forward, "forward", n=6)
    numbers = {"ms": ms, "pairs_per_s": 1000 / ms, "peak_mib": peak, "plain_ms": plain_ms,
               "d_warp": d_warp, "d_moved": d_moved, **prof}
    return out_k, numbers, counts


def published_widths_phase(dev, timer, rehearsal, fx_np, mov_np, tmp):
    """Phase 7: the published inference widths (``config/config_inference.json``,
    enc [256]x4, dec [256]x6) on the in-repo checkpoint, on phase 4's pair.
    7a K8 at every int8 conv shape of that forward; 7b the forward in bf16;
    7c in int8 with the in-repo sidecar; 7d ``register()`` with the published
    config and ``quantize: "int8"``, whose lazy calibration writes a sidecar
    into ``tmp``, and the ``quant-calibrate`` command writing another one
    there: the two agree. Nothing is written under ``benchmarks/``. Returns
    K8's rows, the launch counts of 7b-7d and the phase's numbers."""
    import glob

    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.__main__ import main as port_main
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import Registrar, load_params_any, register
    from multimodal_registration_torch.models.quantize import load_scales
    from multimodal_registration_torch.utils import nifti

    t_phase = time.perf_counter()
    sidecars = {p: open(p, "rb").read()
                for p in glob.glob(os.path.join(HERE, "benchmarks", "*.quant.json"))}
    numbers, counts = {}, {}
    print("# phase 7a: K8 at the int8 conv shapes of the w256 forward (160x160x192, batch 1)",
          flush=True)
    if not rehearsal:
        numbers["k8_build"] = k8_build_report()
    k8_rows = k8_phase(dev, timer, rehearsal)
    numbers["7a_s"] = time.perf_counter() - t_phase

    with open(os.path.join(HERE, "config", "config_inference.json")) as f:
        settings = json.load(f)
    cfg = InferenceConfig.from_dict(dict(settings))
    check(cfg.enc == [256] * 4 and cfg.dec == [256] * 6 and cfg.compute_dtype == "bfloat16",
          f"config_inference.json is not the published w256 bf16 architecture: {cfg}")
    cfg8 = InferenceConfig.from_dict(dict(settings, quantize="int8"))
    params = load_params_any(W256_CKPT, cfg)
    mov_t = torch.as_tensor(mov_np, device=dev)[None, ..., None]
    fx_t = torch.as_tensor(fx_np, device=dev)[None, ..., None]

    print("# phase 7b: the w256 forward in bf16 (K1, K2 x5, K3, cuDNN for the other convs)",
          flush=True)
    reg16 = Registrar(cfg, params, device=dev)
    out16, numbers["7b"], counts["7b"] = w256_forward("7b bf16", reg16.model, mov_t, fx_t,
                                                      timer, rehearsal)
    print("# phase 7c: the w256 forward in int8 with the in-repo sidecar (K8 on 9 convs)",
          flush=True)
    reg8 = Registrar(cfg8, params, device=dev, quant_scales=load_scales(W256_SIDECAR))
    out8, numbers["7c"], counts["7c"] = w256_forward(
        "7c int8", reg8.model, mov_t, fx_t, timer, rehearsal)
    # what int8 costs against bf16: a record (the quantities of
    # benchmarks/quantize_quality_results.json), not a gate
    d = (out8["flow_fullres"] - out16["flow_fullres"]).abs()
    numbers["int8_vs_bf16"] = {
        "flow_mean_vox": float(d.mean()), "flow_max_vox": float(d.max()),
        "moved_max": float((out8["moved"] - out16["moved"]).abs().max())}
    print(f"#   int8 against bf16 (a record, not a gate): full-res flow agreement mean "
          f"{numbers['int8_vs_bf16']['flow_mean_vox']:.5f} voxel, max "
          f"{numbers['int8_vs_bf16']['flow_max_vox']:.4f} voxel; moved max "
          f"{numbers['int8_vs_bf16']['moved_max']:.4f}", flush=True)
    del out16, out8, reg16, reg8, d
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    print("# phase 7d: register() with the published config and quantize int8 (lazy "
          "calibration into a temp sidecar), then quant-calibrate through its argv", flush=True)
    fxp, movp = os.path.join(tmp, "fx.nii.gz"), os.path.join(tmp, "mov.nii.gz")
    nifti.save(nifti.NiftiImage(fx_np, np.eye(4)), fxp)
    nifti.save(nifti.NiftiImage(mov_np, np.eye(4)), movp)
    cfg_path = os.path.join(tmp, "config_inference_int8.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(settings, quantize="int8"), f)
    lazy_path = os.path.join(tmp, "lazy.quant.json")
    reg = Registrar(cfg8, params, device=dev, quant_sidecar=lazy_path)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = register(cfg8, reg, fxp, movp, fx_contrast="T2w", naming="standalone",
                   res_dir=os.path.join(tmp, "res"))
    wall = time.perf_counter() - t0
    counts["7d"] = kernels.launch_counts()
    print(f"#   7d: register() {wall:.3f} s wall, timings (s) {json.dumps(out['timings'])}")
    want = reg.model.kernel_launches()
    launched("7d", counts["7d"], want, rehearsal)
    check(rehearsal or counts["7d"]["conv3_int8"] == want["conv3_int8"],
          f"7d: register() launched {counts['7d']}, want K8 {want['conv3_int8']} times")
    finite_files(out["paths"].values())
    check(os.path.exists(lazy_path), "7d: the lazy calibration wrote no sidecar")
    cli_path = os.path.join(tmp, "cli.quant.json")
    rc = port_main(["quant-calibrate", "--model-path", W256_CKPT, "--config-path", cfg_path,
                    "--pair", f"{fxp},{movp}", "--out", cli_path, "--one-cpu-tf", "False",
                    "--device", dev.type])
    check(rc == 0 and os.path.exists(cli_path), f"quant-calibrate failed ({rc})")
    lazy, cli = load_scales(lazy_path), load_scales(cli_path)
    check(set(lazy) == set(cli) and len(cli) == 9, f"the sidecars hold other keys: {lazy} {cli}")
    rel = max(abs(float(lazy[k]) - float(cli[k])) / abs(float(cli[k])) for k in cli)
    print(f"#   7d: the lazy and the quant-calibrate sidecars: 9 scales, largest relative "
          f"difference {rel:.3e} (tol 1e-6); scales {json.dumps({k: float(v) for k, v in cli.items()})}")
    check(rel <= 1e-6, "the two sidecars disagree")
    after = {p: open(p, "rb").read()
             for p in glob.glob(os.path.join(HERE, "benchmarks", "*.quant.json"))}
    check(after == sidecars, "phase 7 wrote under benchmarks/")
    numbers["7d"] = {"wall_s": wall, "timings": out["timings"], "sidecar_rel_diff": rel}
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 7: {numbers['total_s']:.1f} s of its budget of {PHASE7_BUDGET_S} s "
          f"(7a {numbers['7a_s']:.1f} s)", flush=True)
    return k8_rows, counts, numbers


def real_scan_phases(dev, timer, rehearsal, cfg, params, fx_np, mov_np, tmp):
    """Phases 6a-6e: ``register()`` on scans off the fixed grid (axis-aligned
    and oblique), ``use_subvol``, the two-step cascade through its CLI and the
    three evaluators, each through the kernels and through their plain
    versions. Returns the launch counts of each phase and its numbers."""
    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.evalx import cli as ecli
    from multimodal_registration_torch.infer.blend import blend_subvol_fields
    from multimodal_registration_torch.infer.cascade import _compose_full, register_two_steps
    from multimodal_registration_torch.infer.cli import bids_two_steps
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.preprocess import subvol_grid
    from multimodal_registration_torch.infer.register import (
        Registrar, apply_warp, load_params_any, register)
    from multimodal_registration_torch.utils import nifti

    t_phase = time.perf_counter()
    reg_k = Registrar(cfg, params, device=dev)
    reg_p = Registrar(cfg, params, device=dev, impl="plain")
    counts, numbers = {}, {}
    if rehearsal:
        fixed = ((40, 40, 40), (0.8, 0.8, 1.2))
        moving = ((52, 52, 24), (0.625, 0.625, 2.0))
        subvol = [16, 16, 32]
    else:
        fixed = ((200, 200, 160), (0.8, 0.8, 1.2))   # 160 x 160 x 192 on the 1 mm grid
        moving = ((256, 256, 96), (0.625, 0.625, 2.0))
        subvol = [80, 80, 96]
    fx_aff = scan_affine(*fixed)
    nifti_fx = nifti.NiftiImage(tube_scan(fixed[0], fx_aff, 1), fx_aff)

    def inputs(d, fx_img, mov_img):
        """``fx.nii.gz`` and ``mov.nii.gz`` in ``d/kernels`` and ``d/plain``
        (each side writes its ``_proc`` files beside its inputs)."""
        paths = {}
        for side in ("kernels", "plain"):
            sd = os.path.join(d, side)
            os.makedirs(sd)
            paths[side] = (os.path.join(sd, "fx.nii.gz"), os.path.join(sd, "mov.nii.gz"))
            for img, p, src in zip((fx_img, mov_img), paths[side], paths["kernels"]):
                if side == "kernels":
                    nifti.save(img, p)
                else:
                    shutil.copy(src, p)
        return paths

    def register_both(label, d, cfg_, mov_aff):
        """register() of the pair through the kernels (launches counted) and
        through the plain versions, each into its own directory."""
        outs = {}
        mov_nii = nifti.NiftiImage(tube_scan(moving[0], mov_aff, 2, shift_mm=2.0), mov_aff)
        paths = inputs(d, nifti_fx, mov_nii)
        for side, reg in (("kernels", reg_k), ("plain", reg_p)):
            sd = os.path.join(d, side)
            fxp, movp = paths[side]
            if side == "kernels":
                kernels.reset_launch_counts()
            t0 = time.perf_counter()
            outs[side] = register(cfg_, reg, fxp, movp, fx_contrast="T2w", naming="standalone",
                                  res_dir=os.path.join(sd, "res"))
            wall = time.perf_counter() - t0
            if side == "kernels":
                counts[label] = kernels.launch_counts()
                print(f"#   {label}: register() {wall:.3f} s wall, timings (s) "
                      f"{json.dumps(outs[side]['timings'])}")
        finite_files(outs["kernels"]["paths"].values())
        launched(label, counts[label], reg_k.model.kernel_launches(), rehearsal)
        numbers[label] = kernels_vs_plain(label, outs["kernels"], outs["plain"])
        numbers[label]["timings"] = outs["kernels"]["timings"]
        return outs["kernels"], mov_nii, os.path.join(d, "kernels")

    # ---- 6a. axis-aligned anisotropic pair: the separable spline
    print(f"# phase 6a: register() of an axis-aligned anisotropic pair, fixed {fixed}, "
          f"moving {moving}", flush=True)
    out, mov_nii, d = register_both("6a", os.path.join(tmp, "6a"), cfg, scan_affine(*moving))
    numbers["6a"].update(spline_phase("6a", out, os.path.join(d, "fx_proc.nii.gz"), mov_nii,
                                      timer, dev, rehearsal))

    # ---- 6b. the moving scan rotated 6 degrees about z and shifted 2 mm
    print("# phase 6b: register() of the moving scan rotated 6 deg about z, shifted 2 mm "
          "(oblique linear preprocessing, oblique cubic postprocess)", flush=True)
    mov_aff_b = scan_affine(*moving, rot_deg=6.0, shift=(2.0, 0.0, 0.0))
    out_b, mov_nii_b, d_b = register_both("6b", os.path.join(tmp, "6b"), cfg, mov_aff_b)
    numbers["6b"].update(spline_phase("6b", out_b, os.path.join(d_b, "fx_proc.nii.gz"),
                                      mov_nii_b, timer, dev, rehearsal))

    # ---- 6c. use_subvol on the phase-4 pair
    cfg_sub = InferenceConfig.from_dict(dict(FLAGSHIP, use_subvol=True, subvol_size=subvol))
    print(f"# phase 6c: register() with use_subvol, subvol_size {subvol}, on the phase-4 pair "
          f"{fx_np.shape}", flush=True)
    outs = {}
    paths = inputs(os.path.join(tmp, "6c"), nifti.NiftiImage(fx_np, np.eye(4)),
                   nifti.NiftiImage(mov_np, np.eye(4)))
    for side, reg in (("kernels", reg_k), ("plain", reg_p)):
        fxp, movp = paths[side]
        if side == "kernels":
            kernels.reset_launch_counts()
        outs[side] = register(cfg_sub, reg, fxp, movp, fx_contrast="T2w", naming="bids")
        if side == "kernels":
            counts["6c"] = kernels.launch_counts()
    tile, coords = subvol_grid(cfg_sub, fx_np.shape)
    print(f"#   6c: {len(coords)} tiles of {tile} in chunks of {reg_k.max_batch}; timings (s) "
          f"{json.dumps(outs['kernels']['timings'])}")
    finite_files(outs["kernels"]["paths"].values())
    # Registrar.register_tensors: each chunk of tiles without a moved image
    # (no K3), then one general warp (K2) of the whole volume
    want_6c = reg_k.register_launches(fx_np.shape, cfg_sub)
    launched("6c", counts["6c"], want_6c, rehearsal)
    if not rehearsal:
        check(all(counts["6c"][k] == want_6c[k] for k in counts["6c"]),
              f"6c: the tiled registration should launch what the registrar states "
              f"({want_6c}): {counts['6c']}")
    numbers["6c"] = kernels_vs_plain("6c", outs["kernels"], outs["plain"])
    numbers["6c"]["timings"] = outs["kernels"]["timings"]
    half_tile = tuple(s // 2 for s in tile)
    tile_warps = torch.cat([smooth_field(half_tile, 3.0, 20 + t, dev) for t in range(len(coords))])
    half_coords = [tuple(c // 2 for c in co) for co in coords]
    half_vol = tuple(s // 2 for s in fx_np.shape)

    def blend():
        with torch.inference_mode():
            return blend_subvol_fields(half_tile, half_vol, half_coords, tile_warps)

    numbers["6c"]["blend_ms"] = timer(blend, n=1, reps=3, warmup=1)
    numbers["6c"]["blend_device_ms"], ops, _ = device_time(blend)
    print(f"#   6c: blend of {len(coords)} tile fields {half_tile} into {half_vol}: "
          f"{numbers['6c']['blend_ms']:.3f} ms wall, device {numbers['6c']['blend_device_ms']} ms "
          f"in {ops} operations")
    del tile_warps

    # ---- 6d. the two-step cascade through its CLI, on 6b's pair
    print("# phase 6d: bids_two_steps through its argv (model 1 learned_model1, model 2 "
          "learned_ref, cascade_compose_res full), on 6b's oblique pair", flush=True)
    cfg_path = os.path.join(tmp, "cascade.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(FLAGSHIP, cascade_compose_res="full"), f)
    cfg_c = InferenceConfig.from_json(cfg_path)
    outs = {}
    d_d = os.path.join(tmp, "6d")
    paths = inputs(d_d, nifti_fx, mov_nii_b)
    for side in ("kernels", "plain"):
        fxp, movp = paths[side]
        if side == "kernels":
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            outs[side] = bids_two_steps([
                "--model1-path", CKPT_MODEL1, "--model2-path", CKPT, "--config-path", cfg_path,
                "--fx-img-path", fxp, "--mov-img-path", movp, "--fx-img-contrast", "T2w",
                "--one-cpu-tf", "False"] + (["--device", "cpu"] if rehearsal else []))
            wall = time.perf_counter() - t0
            counts["6d"] = kernels.launch_counts()
        else:
            reg1 = Registrar(cfg_c, load_params_any(CKPT_MODEL1, cfg_c), device=dev, impl="plain",
                             svf_smooth_sigma=cfg_c.model1_svf_smooth_sigma)
            reg2 = Registrar(cfg_c, load_params_any(CKPT, cfg_c), device=dev, impl="plain")
            outs[side] = register_two_steps(cfg_c, reg1, reg2, fxp, movp, fx_contrast="T2w")
            del reg1, reg2
    print(f"#   6d: bids_two_steps {wall:.3f} s wall (two models loaded and built, the CLI's "
          "whole run)")
    finite_files(outs["kernels"]["paths"].values())
    launched("6d", counts["6d"], reg_k.model.kernel_launches(), rehearsal)
    if not rehearsal:
        check(counts["6d"]["conv3_lrelu_pool"] == 2 and counts["6d"]["warp_up2x"] == 2,
              f"6d: two forwards, one per model, want K1 x2, K3 x2: {counts['6d']}")
    numbers["6d"] = kernels_vs_plain("6d", outs["kernels"], outs["plain"])
    numbers["6d"]["wall_s"] = wall
    half = tuple(s // 2 for s in fx_np.shape)
    w1, w2 = smooth_field(half, 3.0, 30, dev)[0], smooth_field(half, 2.0, 31, dev)[0]

    def compose():
        with torch.inference_mode():
            return _compose_full(w1, w2, 2, fx_np.shape)

    numbers["6d"]["compose_ms"] = timer(compose, n=1, reps=3, warmup=1)
    numbers["6d"]["compose_device_ms"], ops, _ = device_time(compose)
    print(f"#   6d: compose on the image grid (both fields upsampled {half} -> {fx_np.shape}, "
          f"K2): {numbers['6d']['compose_ms']:.3f} ms wall, device "
          f"{numbers['6d']['compose_device_ms']} ms in {ops} operations")
    cascade_dir = os.path.join(d_d, "kernels")

    # ---- 6e. the evaluators on 6b's and 6d's outputs
    print("# phase 6e: eval_with_jacobian, eval_with_mi, eval_on_sc_seg on 6b's and 6d's "
          "outputs, through their argv on the device, against the same on the CPU", flush=True)
    from multimodal_registration_torch.evalx.jacobian import folding_summary

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    evals = {}
    for label, d, out_ in (("6b", d_b, out_b), ("6d", cascade_dir, outs["kernels"])):
        vols = {name: nifti.load(os.path.join(d, f"{name}.nii.gz"))
                for name in ("fx_proc", "mov_proc")}
        affine = vols["fx_proc"].affine
        vols = {k: v.get_fdata() for k, v in vols.items()}
        vols["moved"] = nifti.load(out_["paths"]["moved_proc"]).get_fdata()
        # the segmentation: the tube's core in each processed volume, and the
        # moving one warped by the registration's field (nearest, K2)
        segs = {"fx_seg": (vols["fx_proc"] > 0.6).astype(np.float32),
                "mov_seg": (vols["mov_proc"] > 0.6).astype(np.float32)}
        segs["reg_seg"] = apply_warp(segs["mov_seg"], out_["warp_data"], "nearest",
                                     rescale=out_["scale"], device=dev)
        for name, a in segs.items():
            nifti.save(nifti.NiftiImage(a, affine), os.path.join(d, f"{name}.nii.gz"))
        field_path = out_["paths"]["warp_orig"]
        flag = ["--device", "cpu"] if rehearsal else []
        csv = {name: os.path.join(d, f"{name}.csv") for name in ("seg", "nmi", "jac", "cpu")}
        code = ecli.eval_on_sc_seg([
            "--fx-seg-path", os.path.join(d, "fx_seg.nii.gz"),
            "--moving-seg-path", os.path.join(d, "mov_seg.nii.gz"),
            "--warped-seg-path", os.path.join(d, "reg_seg.nii.gz"), "--sub-id", label,
            "--out-file", csv["seg"]] + flag)
        check(code == 0, f"6e: eval_on_sc_seg exited {code}")
        ecli.eval_with_mi([
            "--fx-im-path", os.path.join(d, "fx_proc.nii.gz"),
            "--moving-im-path", os.path.join(d, "mov_proc.nii.gz"),
            "--warped-im-path", out_["paths"]["moved_proc"], "--sub-id", label,
            "--out-file", csv["nmi"]] + flag)
        ecli.eval_with_jacobian([
            "--def-field-path", field_path, "--sub-id", label, "--out-file", csv["jac"],
            "--out-im-path", os.path.join(d, "detJa.nii.gz")] + flag)
        rows = {}
        for name in ("seg", "nmi", "jac"):
            with open(csv[name]) as f:
                lines = f.read().splitlines()
            check(len(lines) == 2, f"6e: {name}.csv has {len(lines)} lines")
            rows[name] = np.array([float(v) for v in lines[1].split(",")[2:]])
            check(bool(np.isfinite(rows[name]).all()), f"6e: {label} {name} not finite")
        # the same evaluations on the CPU, from the same arrays
        _, before, after = ecli.eval_on_sc_seg_arrays(
            segs["fx_seg"], segs["mov_seg"], segs["reg_seg"], label, csv["cpu"], device="cpu")
        nmi = ecli.eval_with_mi_arrays(vols["fx_proc"], vols["mov_proc"], vols["moved"], label,
                                       csv["cpu"], device="cpu")
        fold = folding_summary(nifti.load(field_path).get_fdata(), device="cpu")
        cpu = {"seg": [before["dice"], after["dice"], before["jaccard"], after["jaccard"]],
               "nmi": [nmi["nmi_before"], nmi["nmi_after"], nmi["nmi_moving_moved"]],
               "jac": [fold["percentage_negative_detJa"], fold["median_detJa"],
                       fold["mean_detJa"], fold["std_detJa"]]}
        for name, tol in (("seg", 0.0), ("nmi", 1e-6), ("jac", 1e-5)):
            err = float(np.abs(rows[name][:len(cpu[name])] - np.array(cpu[name])).max())
            check(err <= tol, f"6e: {label} {name} on the device vs the CPU: {err}")
        evals[label] = {"dice_before": rows["seg"][0], "dice_after": rows["seg"][1],
                        "nmi_before": rows["nmi"][0], "nmi_after": rows["nmi"][1],
                        "pct_negative_detJ": rows["jac"][0]}
        print(f"#   6e {label}: Dice before/after {rows['seg'][0]:.4f} / {rows['seg'][1]:.4f}; "
              f"NMI before/after {rows['nmi'][0]:.5f} / {rows['nmi'][1]:.5f}; negative detJ "
              f"{rows['jac'][0]:.5f}% of {int(rows['jac'][4])} voxels (device rows equal the "
              "CPU's within 0 / 1e-6 / 1e-5)")
    counts["6e"] = kernels.launch_counts()
    launched("6e", counts["6e"], {"warp_trilinear": 1}, rehearsal)
    numbers["6e"] = {"wall_s": time.perf_counter() - t0, **evals}
    print(f"#   6e: {numbers['6e']['wall_s']:.3f} s wall for both evaluations, on the device "
          "and on the CPU")
    numbers["total_s"] = time.perf_counter() - t_phase
    return counts, numbers


PHASE8_BUDGET_S = 150  # of the script's 1200 s
PIPELINE_SUBJECTS = ("sub-01", "sub-02", "sub-03/ses-01")


def bids_tree(root, fixed, moving):
    """Phase 8's BIDS dataset: three subjects, one with a session, each with
    a T2w at ``fixed`` and a T1w at ``moving`` (``(shape, voxel mm)``),
    tubes from other seeds and shifts (sub-03's T1w rotated 5 degrees), and
    a JSON sidecar beside each T1w."""
    import numpy as np

    from multimodal_registration_torch.utils import nifti

    data = os.path.join(root, "data")
    for i, sub in enumerate(PIPELINE_SUBJECTS):
        anat = os.path.join(data, sub, "anat")
        os.makedirs(anat)
        prefix = sub.replace("/", "_")
        fa = scan_affine(*fixed, shift=(0.4 * i, -0.3 * i, 0.0))
        ma = scan_affine(*moving, rot_deg=5.0 if i == 2 else 0.0, shift=(0.5 * i, 0.0, 1.0))
        nifti.save(nifti.NiftiImage(tube_scan(fixed[0], fa, 30 + i), fa),
                   os.path.join(anat, f"{prefix}_T2w.nii.gz"))
        nifti.save(nifti.NiftiImage(tube_scan(moving[0], ma, 40 + i, shift_mm=1.5 + i), ma),
                   os.path.join(anat, f"{prefix}_T1w.nii.gz"))
        with open(os.path.join(anat, f"{prefix}_T1w.json"), "w") as f:
            json.dump({"RepetitionTime": 2.0, "EchoTime": 0.0035}, f)
    return data


def _busy_ms(prof):
    """Device time summed over every kernel, copy and memset a profile saw."""
    return sum(_dev_us(e) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3


def _by_phase(results):
    """Each ``timings`` phase, mean over the subjects (s)."""
    keys = sorted({k for r in results for k in r.timings})
    return {k: statistics.mean(r.timings.get(k, 0.0) for r in results) for k in keys}


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def compare_trees(a, b):
    """8a's and 8b's outputs: the same files, each the same bytes, except
    the times of writing: the CSVs' first column (``Timestamp``), and the
    ``seconds`` and ``timings`` of the logs and the summary. Returns the
    files compared with those left out."""
    import csv

    names = _tree(a)
    check(names == _tree(b), f"8a and 8b wrote other files: {sorted(set(names) ^ set(_tree(b)))}")
    lenient = []
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".csv"):
            rows = []
            for p in (pa, pb):
                with open(p, newline="") as f:
                    rows.append([r[1:] for r in csv.reader(f)])
            check(rows[0] == rows[1], f"8a and 8b differ in {n} (beyond the timestamps)")
            lenient.append(n)
        elif n.endswith(".log") or n == "batch_summary.json":
            docs = []
            for p in (pa, pb):
                with open(p) as f:
                    d = json.load(f)
                for k in ("seconds", "timings", "total_seconds"):
                    d.pop(k, None)
                if "per_subject_seconds" in d:
                    d["per_subject_seconds"] = sorted(d["per_subject_seconds"])
                docs.append(d)
            check(docs[0] == docs[1], f"8a and 8b differ in {n} (beyond the times)")
            lenient.append(n)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                check(fa.read() == fb.read(), f"8a and 8b wrote other bytes to {n}")
    return names, lenient


def native_vs_python(paths, rehearsal):
    """8e: NIfTI decode and gz write, native against Python, in MB/s of the
    uncompressed stream, on ``paths``; the native reader's array equal to
    the Python reader's."""
    import gzip
    import io

    import numpy as np

    from multimodal_registration_torch.utils import native, nifti

    rows = []
    for p in paths:
        t0 = time.perf_counter()
        d_native, a_native = native.load_nifti_native(p)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = nifti.load(p)
        d_py = img.get_fdata(np.float32)
        t_py = time.perf_counter() - t0
        check(np.array_equal(d_native, d_py) and np.array_equal(
            a_native, img.affine.astype(np.float32).astype(np.float64)),
            f"8e: the native reader disagrees with the Python reader on {p}")
        with gzip.open(p, "rb") as f:
            payload = f.read()
        mb = len(payload) / 1e6
        out = p + ".8e.gz"
        writes = {}
        t0 = time.perf_counter()
        check(native.write_gz_native(out, payload, 1), "8e: the native gzip writer is missing")
        writes["native_gz1"] = time.perf_counter() - t0
        check(gzip.decompress(open(out, "rb").read()) == payload, "8e: the native gz file differs")
        t0 = time.perf_counter()
        with open(out, "wb") as f:
            f.write(nifti._gz_compress_adaptive(payload))
        writes["python_adaptive"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bio = io.BytesIO()
        with gzip.GzipFile(fileobj=bio, mode="wb", mtime=0, compresslevel=1) as f:
            f.write(payload)
        with open(out, "wb") as f:
            f.write(bio.getvalue())
        writes["python_gzip1"] = time.perf_counter() - t0
        os.remove(out)
        row = {"file": os.path.basename(p), "mb": mb, "gz_mb": os.path.getsize(p) / 1e6,
               "decode_native_mb_s": mb / t_native, "decode_python_mb_s": mb / t_py,
               **{f"write_{k}_mb_s": mb / v for k, v in writes.items()}}
        print(f"#   8e: {row['file']} ({mb:.1f} MB raw, {row['gz_mb']:.1f} MB on disk): decode "
              f"native {row['decode_native_mb_s']:.1f} MB/s, Python {row['decode_python_mb_s']:.1f}"
              f" MB/s (arrays equal); gz write native level 1 "
              f"{row['write_native_gz1_mb_s']:.1f} MB/s, Python adaptive "
              f"{row['write_python_adaptive_mb_s']:.1f}, Python gzip level 1 "
              f"{row['write_python_gzip1_mb_s']:.1f} (host clock)", flush=True)
        rows.append(row)
    return rows


def pipeline_phase(dev, rehearsal, tmp):
    """Phase 8: the BIDS batch pipeline at the published widths on the
    in-repo w256 checkpoint, over :func:`bids_tree`'s three subjects:
    8a ``run_batch`` (write-behind and native prefetch), 8b the same subjects
    through a loop of ``run_subject`` with synchronous writes, whose output
    tree must equal 8a's, 8c the opt-affine fallback (K2's warp held against
    its plain version), 8d int8 with the in-repo sidecar (against the plain
    path), 8e the native NIfTI runtime against the Python reader and writer.
    Returns the launch counts of 8a-8d and the phase's numbers."""
    import glob

    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import Registrar, load_params_any, register
    from multimodal_registration_torch.infer.sharded import make_registrar
    from multimodal_registration_torch.models.quantize import load_scales
    from multimodal_registration_torch.ops.warp import warp
    from multimodal_registration_torch.pipeline import batch, segment
    from multimodal_registration_torch.pipeline.qc import QCReport
    from multimodal_registration_torch.pipeline.runner import PipelineConfig, run_subject
    from multimodal_registration_torch.utils import native, nifti

    t_phase = time.perf_counter()
    counts, numbers = {}, {}
    cfg_path = os.path.join(HERE, "config", "config_inference.json")
    with open(cfg_path) as f:
        settings = json.load(f)
    want, want8 = forward_launches(settings), forward_launches(dict(settings, quantize="int8"))
    if rehearsal:
        fixed, moving = ((40, 40, 32), (0.8, 0.8, 1.2)), ((52, 52, 20), (0.625, 0.625, 2.0))
    else:
        fixed, moving = ((200, 200, 160), (0.8, 0.8, 1.2)), ((256, 256, 96), (0.625, 0.625, 2.0))
    t0 = time.perf_counter()
    lib = native.build_lib()  # raises when the library does not build
    check(native.get_lib() is not None, "the native NIfTI runtime did not load")
    check(not os.environ.get("MMREG_NO_PREFETCH"), "MMREG_NO_PREFETCH is set: 8a would not prefetch")
    print(f"# phase 8: the BIDS batch pipeline (published widths, {cfg_path}), subjects "
          f"{PIPELINE_SUBJECTS}, T2w {fixed}, T1w {moving}; native NIfTI runtime {lib} "
          f"({time.perf_counter() - t0:.2f} s to build or find)", flush=True)
    data = bids_tree(tmp, fixed, moving)
    snapshot = {p: (open(p, "rb").read() if p.endswith(".json") else os.path.getmtime(p))
                for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def profiled(fn):
        """``fn()`` under the profiler on the card -> (result, wall s, busy ms)."""
        if rehearsal:
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0, None
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
            time.sleep(0.002)
        return out, wall, _busy_ms(prof)

    def report(label, results, span, wall, busy_ms):
        """``span``: the seconds from the first subject's start to the end of
        the last (the registrar is built before); ``wall``: the whole call."""
        n = len(results)
        check(n == len(PIPELINE_SUBJECTS) and all(r.ok for r in results),
              f"{label}: subjects failed: {[(r.subject, r.error) for r in results if not r.ok]}")
        row = {"s_per_subject": span / n, "span_s": span, "wall_s": wall,
               "subject_s": {r.subject: r.seconds for r in results},
               "timings": _by_phase(results)}
        busy = "not measured"
        if busy_ms is not None:
            row.update(busy_ms_per_subject=busy_ms / n,
                       idle_share=max(0.0, 1.0 - busy_ms / 1e3 / span))
            busy = f"{busy_ms / n:.1f} ms a subject, idle share {row['idle_share']:.4f}"
        print(f"#   {label}: {row['s_per_subject']:.3f} s/subject ({span:.3f} s for {n} subjects, "
              f"each {json.dumps({k: round(v, 3) for k, v in row['subject_s'].items()})}; "
              f"{wall:.3f} s with building the registrar); device busy {busy}", flush=True)
        print(f"#   {label}: timings by phase, mean of {n} subjects (s): "
              f"{json.dumps({k: round(v, 3) for k, v in row['timings'].items()})}", flush=True)
        return row

    # ---- 8a. run_batch: write-behind saves, native prefetch
    print("# phase 8a: run_batch over the three subjects (write-behind, native prefetch), "
          "under the profiler", flush=True)
    out_a = os.path.join(tmp, "8a")
    kernels.reset_launch_counts()
    (results, summary), wall, busy = profiled(lambda: batch.run_batch(
        data, out_a, W256_CKPT, config_path=cfg_path, device=dev.type))
    counts["8a"] = kernels.launch_counts()
    numbers["8a"] = report("8a", results, summary["total_seconds"], wall, busy)
    launched("8a", counts["8a"], want, rehearsal)
    check(rehearsal or counts["8a"]["conv3_lrelu_pool"] == len(PIPELINE_SUBJECTS),
          f"8a: K1 ran {counts['8a']['conv3_lrelu_pool']} times, want one a subject")
    check(not nifti._ASYNC_ENABLED and not nifti._PENDING_IMGS,
          "8a: write-behind outlived run_batch")
    res_files = glob.glob(os.path.join(out_a, "data_processed", "*", "res", "*.nii.gz"))
    check(len(res_files) == 2 * len(PIPELINE_SUBJECTS), f"8a: res/ holds {res_files}")
    finite_files(res_files)

    # ---- 8b. the same through a loop of run_subject, synchronous writes
    print("# phase 8b: the same subjects through a loop of run_subject on one registrar, "
          "synchronous writes, no prefetch, under the profiler", flush=True)
    with nifti._LOAD_CACHE_LOCK:  # start from the cache state 8a started from
        nifti._LOAD_CACHE.clear()
    nifti._LOAD_CACHE_ACTIVE = False
    cfg = InferenceConfig.from_json(cfg_path)
    params = load_params_any(W256_CKPT, cfg)
    out_b = os.path.join(tmp, "8b")
    path_processed, path_qc, path_log = batch.provision(out_b)

    def loop():
        registrar = make_registrar(cfg, params, device=dev)
        qc = QCReport(path_qc)
        t0 = time.time()
        res = []
        for s in PIPELINE_SUBJECTS:
            res.append(run_subject(cfg, PipelineConfig(), registrar, data, path_processed, s,
                                   segmenter=segment.default_segmenter(), qc=qc))
            batch.write_subject_log(path_log, res[-1])
        qc.write()
        return res, batch.write_summary(out_b, res, time.time() - t0)

    kernels.reset_launch_counts()
    (results_b, summary_b), wall_b, busy_b = profiled(loop)
    counts["8b"] = kernels.launch_counts()
    numbers["8b"] = report("8b", results_b, summary_b["total_seconds"], wall_b, busy_b)
    check(counts["8b"] == counts["8a"], f"8b launched {counts['8b']}, 8a {counts['8a']}")
    names, lenient = compare_trees(out_a, out_b)
    numbers["8a_vs_8b"] = {"files": len(names), "equal_but_times": lenient}
    print(f"#   8a and 8b wrote the same {len(names)} files, byte for byte but for the times of "
          f"writing in {lenient} (the CSVs' Timestamp column; seconds and timings of the logs "
          f"and the summary)", flush=True)
    numbers["8b_over_8a"] = numbers["8b"]["s_per_subject"] / numbers["8a"]["s_per_subject"]

    # ---- 8c. opt-affine with the fallback forced: apply_affine_field on K2
    print("# phase 8c: sub-01 with --opt-affine --min-sc-dice 101 (the centermass fallback: "
          "apply_affine_field on K2, then register() again)", flush=True)
    out_c = os.path.join(tmp, "8c")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res_c, sum_c = batch.run_batch(data, out_c, W256_CKPT, config_path=cfg_path,
                                   include_list=["sub-01"], opt_affine=True, min_sc_dice=101,
                                   device=dev.type)
    numbers["8c"] = {"wall_s": time.perf_counter() - t0, "timings": res_c[0].timings}
    counts["8c"] = kernels.launch_counts()
    launched("8c", counts["8c"], want, rehearsal)
    check(res_c[0].ok and sum_c["n_affine_fallback"] == 1,
          f"8c: the fallback was not taken: {sum_c} {res_c[0].error}")
    check(rehearsal or counts["8c"]["conv3_lrelu_pool"] == 2,
          f"8c: K1 ran {counts['8c']['conv3_lrelu_pool']} times, want 2 (two registrations)")
    work = os.path.join(out_c, "data_processed", "sub-01")
    field = segment.centermass_affine_field(
        nifti.load(os.path.join(work, "seg", "sub-01_T2w_proc_seg.nii.gz")).get_fdata(),
        nifti.load(os.path.join(work, "seg", "sub-01_T1w_proc_seg.nii.gz")).get_fdata())
    mov_proc = nifti.load(os.path.join(work, "add_res", "sub-01_T1w_proc.nii.gz")).get_fdata()
    got = nifti.load(os.path.join(work, "add_res", "sub-01_T1w_affine.nii.gz")).get_fdata()
    with torch.inference_mode():
        plain = warp(torch.as_tensor(mov_proc, dtype=torch.float32, device=dev),
                     torch.as_tensor(field, device=dev), "linear", impl="plain").cpu().numpy()
    err = float(np.abs(got - plain).max())
    print(f"#   8c: {numbers['8c']['wall_s']:.3f} s; launches {counts['8c']}; the affine-aligned "
          f"volume {mov_proc.shape} (K2) vs its plain version: max_abs_err {err:.3e} "
          f"(tol 1e-5); max|field| {float(np.abs(field).max()):.3f} voxel", flush=True)
    check(err <= 1e-5, "8c: apply_affine_field disagrees with the plain warp")
    numbers["8c"]["k2_vs_plain"] = err

    # ---- 8d. int8 with the in-repo sidecar: K8 inside the pipeline
    print("# phase 8d: sub-01 with quantize int8 and the in-repo sidecar (K8 on 9 convs), "
          "against register() through the plain versions", flush=True)
    cfg8_path = os.path.join(tmp, "config_inference_int8.json")
    with open(cfg8_path, "w") as f:
        json.dump(dict(settings, quantize="int8"), f)
    out_d = os.path.join(tmp, "8d")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res_d, _ = batch.run_batch(data, out_d, W256_CKPT, config_path=cfg8_path,
                               include_list=["sub-01"], device=dev.type)
    numbers["8d"] = {"wall_s": time.perf_counter() - t0, "timings": res_d[0].timings}
    counts["8d"] = kernels.launch_counts()
    check(res_d[0].ok, f"8d failed: {res_d[0].error}")
    launched("8d", counts["8d"], want8, rehearsal)
    check(rehearsal or counts["8d"]["conv3_int8"] == want8["conv3_int8"],
          f"8d: K8 ran {counts['8d']['conv3_int8']} times, want {want8['conv3_int8']}")
    cfg8 = InferenceConfig.from_json(cfg8_path)
    reg_p = Registrar(cfg8, params, device=dev, impl="plain", quant_scales=load_scales(W256_SIDECAR))
    pdir = os.path.join(tmp, "8d_plain")
    os.makedirs(pdir)
    anat = os.path.join(data, "sub-01", "anat")
    for c in ("T2w", "T1w"):
        shutil.copy(os.path.join(anat, f"sub-01_{c}.nii.gz"), pdir)
    register(cfg8, reg_p, os.path.join(pdir, "sub-01_T2w.nii.gz"),
             os.path.join(pdir, "sub-01_T1w.nii.gz"), fx_contrast="T2w")
    work = os.path.join(out_d, "data_processed", "sub-01")
    pairs = {"field": ("add_res", "sub-01_T1w_proc_field_to_T2w.nii.gz"),
             "moved": ("res", "sub-01_T1w_proc_reg_to_T2w.nii.gz")}
    d8 = {}
    for k, (sub_dir, name) in pairs.items():
        a = nifti.load(os.path.join(work, sub_dir, name)).get_fdata()
        b = nifti.load(os.path.join(pdir, name)).get_fdata()
        d8[k] = float(np.abs(a - b).max())
    print(f"#   8d: {numbers['8d']['wall_s']:.3f} s; launches {counts['8d']}; against the plain "
          f"path: field {d8['field']:.3e} voxel (tol 0.1), moved {d8['moved']:.3e} (tol 0.05)",
          flush=True)
    check(d8["field"] <= 0.1 and d8["moved"] <= 0.05, "8d: the int8 pipeline disagrees with the plain path")
    numbers["8d"].update(d8)
    del reg_p, params
    after = {p: (open(p, "rb").read() if p.endswith(".json") else os.path.getmtime(p))
             for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}
    check(after == snapshot, "phase 8 changed something under benchmarks/")

    # ---- 8e. the native NIfTI runtime against the Python reader and writer
    print("# phase 8e: native against Python on sub-01's largest output (8a)", flush=True)
    files = sorted(glob.glob(os.path.join(out_a, "data_processed", "sub-01", "*", "*.nii.gz")),
                   key=os.path.getsize)[-1:]
    numbers["8e"] = native_vs_python(files, rehearsal)

    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 8: {numbers['total_s']:.1f} s of its budget of {PHASE8_BUDGET_S} s",
          flush=True)
    return counts, numbers


PHASE9_BUDGET_S = 180  # of the script's 1200 s
LEARN_STEPS = 1000  # 9a: a third of the svf4 probe's 3000 (benchmarks/svf4_learn_results.json)
WARM_STEPS = 300    # 9b
# a training step's kernels in a profiler trace, by their CUDA function names
TRACE_NAMES = {
    "warp_trilinear": ("self_warp_add_kernel", "warp_kernel"),
    "max_pool_2x_bwd": ("pool_bwd_kernel",),
    "warp_trilinear_bwd": ("self_warp_add_bwd_kernel", "warp_bwd_tiled_kernel",
                           "warp_bwd_kernel"),
    "warp_labels_soft_hard": ("warp_labels_kernel",),
    "warp_labels_dice_fwd": ("warp_labels_dice_fwd_kernel", "warp_labels_dice_reduce_kernel"),
    "warp_labels_bwd": ("warp_labels_dice_bwd_kernel",),
}


def trace_kernel_names(path):
    """The names of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if str(e.get("cat", "")).lower() == "kernel"}


def learning_phase(dev, rehearsal, tmp):
    """Phase 9: the port's training learns at full width. 9a trains the
    flagship model from scratch (96^3, 16 labels, 1000 steps) and holds it
    against the identity on held-out pairs; 9b warm-starts from the in-repo
    ``learned_ref`` checkpoint (160x160x192, 26 labels, 300 steps); 9c traces
    three of 9a's training steps with ``device_trace``. Returns the launch
    counts of each and the phase's numbers."""
    import glob
    import re

    import numpy as np

    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.tools import learn_check as lc
    from multimodal_registration_torch.train.trainer import Trainer, synthesize
    from multimodal_registration_torch.utils.profiling import device_trace

    t_phase = time.perf_counter()
    counts, numbers = {}, {}
    snapshot = {p: os.path.getmtime(p) for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}
    with open(os.path.join(HERE, "benchmarks", "svf4_learn_results.json")) as f:
        jax_ref = json.load(f)
    path_kernels = tuple(k.name for k in kernels.KERNELS if k.name != "conv3_int8")

    def show(label, res):
        for p in res["trajectory"]:
            print(f"#   {label} step {p['step']}: loss {p['loss']}, Dice {p['dice']:.4f}, "
                  f"NMI {p['nmi']:.4f}, mean |flow| {p['mean_abs_flow_vox']:.4f} voxel, "
                  f"{p['sec_per_step']:.4f} s/step", flush=True)
        s = res["step_seconds"]
        print(f"#   {label}: identity Dice {res['dice_identity']:.4f}, NMI {res['nmi_identity']:.4f}; "
              f"loss mean of the first {res['loss_window']} steps {res['loss_first_mean']}, "
              f"of the last {res['loss_last_mean']}; s/step p50 {s.get('p50')}, p90 {s.get('p90')} "
              f"(StepTimer, synchronised); learned: {str(res['learned']).lower()}", flush=True)

    # ---- 9a. from scratch, flagship widths, 96^3, 16 labels
    shape_a, labels_a, steps_a = ((16, 16, 16), 4, 4) if rehearsal else ((96, 96, 96), 16,
                                                                       LEARN_STEPS)
    print(f"# phase 9a: learn_check from scratch, {shape_a}, {labels_a} labels, {steps_a} steps",
          flush=True)
    t0 = time.perf_counter()
    # the kernels against their plain versions at 9a's shapes (labels-innermost
    # width 16 for K6/K7) before training: phase 5's fixed-batch check on a
    # trainer of 9a's configuration and a pair synthesised from its first map
    cfg_a = lc.check_config(shape_a, labels_a)
    check_trainer = Trainer(cfg_a, device=dev)
    with torch.no_grad():  # a flow head far from zero, so that every branch carries signal
        check_trainer.model.flow.weight.mul_(2000.0)
    map0 = torch.as_tensor(lc.map_bank(cfg_a, dev, num_maps=1)[0], device=dev)[None]
    batch = synthesize(check_trainer.generator(2), map0, map0, check_trainer.engine_cfg, cfg_a,
                       False)
    fixed_batch_check("9a fixed batch", check_trainer, batch)
    del check_trainer, batch, map0
    t_check = time.perf_counter() - t0
    kernels.reset_launch_counts()
    res_a, trainer, bank = lc.learn_check(steps_a, shape_a, labels_a, device=dev)
    counts["9a"] = kernels.launch_counts()
    numbers["9a"] = dict(res_a, wall_s=time.perf_counter() - t0)
    show("9a", res_a)
    for arm, traj in jax_ref["arms"].items():
        last = traj[-1]
        print(f"#   9a reference, the JAX package's svf4 probe, svf_int_res {arm}, "
              f"{jax_ref['workload']}: at step {last['step']} Dice {last['dice']} "
              f"({last['dice'] - jax_ref['identity']['dice']:+.4f} on its identity "
              f"{jax_ref['identity']['dice']}), NMI {last['nmi']} "
              f"({last['nmi'] - jax_ref['identity']['nmi']:+.4f}); other pairs, no gate on the gain")
    print(f"#   9a: launches {counts['9a']}; {numbers['9a']['wall_s']:.1f} s, of which the "
          f"fixed-batch check {t_check:.1f} s", flush=True)
    # the trained model's evaluation forward through the kernels against their
    # plain versions, on 9a's held-out pairs (remade from its bank and seed):
    # phase 3's limits on one pair's forward, and Dice and NMI of all three
    pairs = lc.held_out_pairs(list(bank), trainer.engine_cfg, trainer.generator(lc.SEED_PAIRS),
                              dev)
    mov, _, fx, _ = pairs[0]
    with torch.inference_mode():
        out_k = trainer.model(mov[None, ..., None], fx[None, ..., None])
        out_p = trainer.model(mov[None, ..., None], fx[None, ..., None], impl="plain")
    d_warp = float((out_k["warp"] - out_p["warp"]).abs().max())
    d_moved = float((out_k["moved"] - out_p["moved"]).abs().max())
    ev_k = lc.evaluate(trainer.model, pairs, labels_a)
    ev_p = lc.evaluate(trainer.model, pairs, labels_a, impl="plain")
    d_dice, d_nmi = abs(ev_k["dice"] - ev_p["dice"]), abs(ev_k["nmi"] - ev_p["nmi"])
    print(f"#   9a trained forward, kernels vs plain: warp max_abs_diff {d_warp:.3e} voxel "
          f"(tol 0.1), moved {d_moved:.3e} (tol 0.05); held-out Dice {ev_k['dice']:.4f} vs "
          f"{ev_p['dice']:.4f}, NMI {ev_k['nmi']:.4f} vs {ev_p['nmi']:.4f} (tol 0.01 each); "
          f"the trajectory's last Dice {res_a['dice_after']:.4f}", flush=True)
    numbers["9a"].update(d_warp=d_warp, d_moved=d_moved, d_dice=d_dice, d_nmi=d_nmi)
    check(d_warp <= 0.1 and d_moved <= 0.05,
          "9a: the trained forward through the kernels disagrees with the plain forward")
    check(d_dice <= 0.01 and d_nmi <= 0.01,
          f"9a: held-out Dice/NMI through the kernels disagree with the plain path: {ev_k} {ev_p}")
    del pairs, mov, fx, out_k, out_p
    if not rehearsal:
        check(all(counts["9a"][k] >= 1 for k in path_kernels),
              f"9a: a kernel of the training and evaluation path was not launched: {counts['9a']}")
        check(res_a["learned"], "9a: the model did not learn: held-out Dice or NMI not above "
              f"the identity's: {res_a['trajectory'][-1]}")
        check(res_a["loss_last_mean"] < res_a["loss_first_mean"],
              f"9a: the loss did not fall: {res_a['loss_first_mean']} -> {res_a['loss_last_mean']}")

    # ---- 9b. warm start from the in-repo checkpoint at the reference workload
    shape_b, steps_b = ((16, 16, 16), 2) if rehearsal else ((160, 160, 192), WARM_STEPS)
    print(f"# phase 9b: learn_check warm from {os.path.basename(CKPT)}, {shape_b}, 26 labels, "
          f"{steps_b} steps", flush=True)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    res_b, trainer_b, _ = lc.learn_check(steps_b, shape_b, 26, warm=CKPT, device=dev)
    counts["9b"] = kernels.launch_counts()
    numbers["9b"] = dict(res_b, wall_s=time.perf_counter() - t0)
    del trainer_b
    show("9b", res_b)
    first, last = res_b["trajectory"][0], res_b["trajectory"][-1]
    print(f"#   9b reference, the JAX package's record (benchmarks/learn_ref_results.json, other "
          "pairs): step 0 Dice 0.9046 against 0.8112 for the identity, NMI 1.0287 against 1.0215")
    print(f"#   9b: launches {counts['9b']}; {numbers['9b']['wall_s']:.1f} s", flush=True)
    if not rehearsal:
        check(all(counts["9b"][k] >= 1 for k in path_kernels),
              f"9b: a kernel of the training and evaluation path was not launched: {counts['9b']}")
        check(first["step"] == 0 and first["dice"] > res_b["dice_identity"]
              and first["nmi"] > res_b["nmi_identity"],
              f"9b: the learned checkpoint does not beat the identity at step 0: {first}")
        check(last["dice"] >= first["dice"] - 0.01,
              f"9b: Dice fell by more than 0.01 in {steps_b} steps: {first['dice']} -> "
              f"{last['dice']}")
    after = {p: os.path.getmtime(p) for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}
    check(after == snapshot, "phase 9 changed something under benchmarks/")

    # ---- 9c. device_trace around three of 9a's training steps
    print("# phase 9c: device_trace around three training steps of 9a's trainer", flush=True)
    gen = trainer.generator(7)
    si, ti = trainer.put_indices(np.array([0]), np.array([0]))
    trainer.train_step_banked(gen, bank, si, ti)
    kernels.reset_launch_counts()
    with device_trace(os.path.join(tmp, "trace")) as trace_path:
        for _ in range(3):
            trainer.train_step_banked(gen, bank, si, ti)
    counts["9c"] = kernels.launch_counts()
    per_step = {k: v / 3 for k, v in counts["9c"].items()}
    check(os.path.exists(trace_path), f"9c: no trace at {trace_path}")
    names = trace_kernel_names(trace_path)
    found = {k: sorted({s for s in subs for n in names
                        if re.search(rf"(?<![A-Za-z0-9_]){s}(?![A-Za-z0-9_])", n)})
             for k, subs in TRACE_NAMES.items()}
    numbers["9c"] = {"trace_mb": os.path.getsize(trace_path) / 1e6, "kernel_names": len(names),
                     "per_step": per_step, "found": found}
    print(f"#   9c: {trace_path} ({numbers['9c']['trace_mb']:.1f} MB, {len(names)} kernel names); "
          f"launches per step {per_step}; kernels named in the trace {found}", flush=True)
    want = trainer.step_launches()
    if not rehearsal:
        check(per_step == want, f"9c: a step launched {per_step}, want {want}")
        check(all(found.values()), f"9c: the trace does not name every training kernel: {found}")
    del trainer, bank

    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 9: {numbers['total_s']:.1f} s of its budget of {PHASE9_BUDGET_S} s",
          flush=True)
    return counts, numbers


PHASE10_BUDGET_S = 120  # of the script's 1200 s


def mesh_devices_of(dev, n):
    """``n`` mesh devices: distinct cards while there are enough, then
    repeats (``cuda:0`` twice on a one-card machine); the CPU ``n`` times in
    the rehearsal."""
    import torch

    if dev.type == "cpu":
        return [dev] * n
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def f2_rule(label, got, want, field_max, ulps=1):
    """The F2 rule of ``tests/_torch_port.py::assert_same_outputs`` on a
    registrar's outputs: ``("warp", ...)`` within ``ulps`` bf16 ulps (1 in
    the rule) of the largest int-res field, ``("moved", ...)`` within that of
    the full-res field (twice the int-res one) or 1e-3. Where the limit
    comes from: cuDNN may sum a bf16 conv in another order for another shape
    (a slab, a batch size), which flips the roundings of bf16 activations all
    through the network; a flipped bf16 payload of the integration's last
    step moves a field value by its weight (< 1) times one ulp of the
    payload, and the largest payloads lie in the binade of the field's
    maximum. The flips in the U-Net reach the field through the float32 head
    as the head's weights times the activations' ulps, which the rule does
    not bound: on learned weights (fields of voxels) they stay below it
    (0.49-0.71 ulp for a batch of 2, PERF.md section 6), on an initial head
    (fields of 1e-4 voxel) they read up to 1.973 ulp, hence ``ulps``. The
    limit is reached from below (PERF.md section 5 has the measured values).
    A second requirement holds the flips to what is rare: at most 1e-3 of
    the field's values beyond half the limit (a halo fault moves whole
    planes, one of them 1.25e-2 of the int-res field at 160x160x192).
    Returns the errors and the counts."""
    errs = {}
    ulp = bf16_ulp(field_max)
    for name, tol in (("warp", ulps * ulp), ("moved", max(ulps * bf16_ulp(2 * field_max), 1e-3))):
        d = (got[name].float() - want[name].float()).abs()
        errs[name] = float(d.max())
        print(f"#   {label}: {name} max_abs_diff {errs[name]:.3e} (tolerance {tol:.3e}) = "
              f"{errs[name] / ulp:.3f} ulp of the field")
        check(errs[name] <= tol, f"{label}: {name} disagrees with the reference beyond the F2 rule")
        if name == "warp":
            flips = int((d > tol / 2).sum())
            errs.update(warp_ulps=errs[name] / ulp, warp_flips=flips, warp_values=d.numel(),
                        warp_over_1e5=float((d > 1e-5).float().mean()))
            print(f"#   {label}: warp values beyond half the limit {flips} of {d.numel()} (at "
                  f"most 1e-3 of them), beyond 1e-5 a share of {errs['warp_over_1e5']:.4f}")
            check(flips <= 1e-3 * d.numel(), f"{label}: {flips} warp values beyond half the limit")
    return errs


def kernel_vs_plain(label, got, plain):
    """Phase 3's limits for a forward through the kernels against the same
    forward through their plain versions: warp within 0.1 voxel, moved
    within 0.05 (K1's float32 sums round to the other bf16 neighbour than
    cuDNN's in places, and those flips run through the bf16 network)."""
    d_warp = float((got["warp"] - plain["warp"]).abs().max())
    d_moved = float((got["moved"] - plain["moved"]).abs().max())
    print(f"#   {label}: kernels vs plain: warp {d_warp:.3e} voxel (tol 0.1), "
          f"moved {d_moved:.3e} (tol 0.05)")
    check(d_warp <= 0.1 and d_moved <= 0.05, f"{label}: the kernel forward disagrees with the plain one")
    return {"plain_warp": d_warp, "plain_moved": d_moved}


def k1_slab_check(label, reg, mov, fx):
    """K1 on the halo'd slabs that ``reg``'s first data row gives enc_0 for
    ``mov``, ``fx`` ``(B, X, Y, Z)``, against its plain version: phase 2's
    tolerance, 1 bf16 ulp of max|out|. Returns the largest error."""
    import torch

    from multimodal_registration_torch.ops.conv_pool import conv3_lrelu_pool
    from multimodal_registration_torch.parallel.mesh import split_rows, split_slabs
    from multimodal_registration_torch.parallel.spatial import with_halo

    data = reg.mesh.shape["data"]
    devs = list(reg.mesh.devices[0])
    pad = (-mov.shape[0]) % data
    x = torch.stack([mov, fx], -1)
    x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x
    errs = []
    with torch.inference_mode():
        for k, slab in enumerate(with_halo(split_slabs(split_rows(x, reg.mesh)[0].bfloat16(), devs), 2)):
            block = reg.models[devs[k]].unet.enc_0
            w, b = block.conv.weight, block.conv.bias
            p = conv3_lrelu_pool(slab, w, b, 0.2, impl="plain")
            errs.append(compare(f"{label}: K1 on slab {k} {tuple(slab.shape)} (tol 1 bf16 ulp of "
                                f"max|out|)", conv3_lrelu_pool(slab, w, b, 0.2), p,
                                bf16_ulp(float(p.float().abs().max()))))
    return max(errs)


def same_output_files(label, d_single, d_sharded):
    """The same NIfTI files in both trees, fields within 1 bf16 ulp of the
    largest field and moved images within that or 1e-3 (the F2 rule), the
    rest within 1e-5. Returns the largest differences."""
    import numpy as np

    from multimodal_registration_torch.utils import nifti

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                      for f in fs if f.endswith(".nii.gz"))

    names = files(d_single)
    check(names == files(d_sharded), f"{label}: other files {names} vs {files(d_sharded)}")
    data = {n: [nifti.load(os.path.join(d, n)).get_fdata() for d in (d_single, d_sharded)]
            for n in names}
    is_field = {n: "field" in n or "warp" in n for n in names}
    field_tol = bf16_ulp(max(float(np.abs(a).max()) for n, (a, _) in data.items() if is_field[n]))
    errs = {}
    for n, (a, b) in data.items():
        tol = field_tol if is_field[n] else max(field_tol, 1e-3) if "reg" in n else 1e-5
        errs[n] = float(np.abs(a - b).max())
        check(a.shape == b.shape and errs[n] <= tol,
              f"{label}: {n} differs by {errs[n]:.3e} (tolerance {tol:.3e})")
    print(f"#   {label}: {len(names)} NIfTI files, sharded against one device: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (field tolerance {field_tol:.3e})")
    return errs


def multi_gpu_phase(dev, timer, rehearsal, fx_np, mov_np, tmp):
    """Phase 10: multi-GPU (item 15) on the mesh's devices: distinct cards
    where there are enough, ``cuda:0`` repeated otherwise. 10a the flagship
    forward through ``ShardedRegistrar`` ``{space: 2}`` against the
    single-device ``Registrar``; 10b ``{data: 2}`` on a batch of 3 and
    ``{data: 2, space: 2}`` on a batch of 2, then each layout on more
    inputs and the single device at batch 2 against batch 1; 10c the
    published widths in int8 ``{space: 2}`` with the in-repo sidecar, and
    the lazy calibration over slabs against one device's; 10d
    ``pair_registration`` and ``bids_two_steps`` through their argv with
    ``--space 2`` against the same without it, and ``make_registrar``
    refusing more devices than there are; 10e data-parallel training at
    full width. In 10a-10c the sharded forward through the kernels is also
    held against the same mesh through their plain versions, and K1 and K8
    against theirs on the slab shapes. With ``cuda:0`` repeated, 10e's two
    replicas are one model (``replicate`` keeps one copy a device): their
    backwards sum into its gradients, and the copy-and-sum of distinct
    devices runs only in the CPU tests (``cpu`` and ``cpu:0``). Returns the
    launch counts of each and the phase's numbers."""
    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.infer.cli import bids_two_steps, pair_registration
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import Registrar, load_params_any
    from multimodal_registration_torch.infer.sharded import ShardedRegistrar, make_registrar
    from multimodal_registration_torch.models.quantize import load_scales
    from multimodal_registration_torch.parallel.mesh import make_mesh
    from multimodal_registration_torch.train.cli import run_training
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import Trainer
    from multimodal_registration_torch.utils import nifti

    t_phase = time.perf_counter()
    counts, numbers = {}, {}
    cuda = dev.type == "cuda"
    shape = tuple(fx_np.shape)

    def mesh(data, space):
        return make_mesh(data * space, space=space, devices=mesh_devices_of(dev, data * space))

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_mib():
        return torch.cuda.max_memory_allocated() / 2**20 if cuda else float("nan")

    def predicted(reg, mov, fx):
        moved, warp = reg.predict_tensors(mov, fx)
        return {"moved": moved, "warp": warp}

    cfg = InferenceConfig.from_dict(dict(FLAGSHIP))
    params = load_params_any(CKPT, cfg)
    mov1 = torch.as_tensor(mov_np, device=dev)[None]
    fx1 = torch.as_tensor(fx_np, device=dev)[None]
    single = Registrar(cfg, params, device=dev)

    # ---- 10a. the flagship forward over {space: 2}
    m2 = mesh(1, 2)
    print(f"# phase 10a: the flagship forward through ShardedRegistrar {{space: 2}} on {m2}, "
          f"against Registrar on {dev}, {shape}", flush=True)
    sharded = ShardedRegistrar(cfg, params, m2)
    want = predicted(single, mov1, fx1)
    kernels.reset_launch_counts()
    got = predicted(sharded, mov1, fx1)
    counts["10a"] = kernels.launch_counts()
    seen = {**counts["10a"], **kernels.entry_launch_counts()}
    print(f"#   10a: launches per sharded forward {seen}")
    expect = single.model.kernel_launches(slabs=2)
    if not rehearsal:
        check(seen == expect,
              f"10a: launched {seen}, want {expect} (K1, K9, K10 x3, K11 x9 a slab)")
    field_max = float(want["warp"].abs().max())
    numbers["10a"] = f2_rule("10a", got, want, field_max)
    numbers["10a"]["max_abs_warp"] = field_max
    numbers["10a"].update(kernel_vs_plain(
        "10a", got, predicted(ShardedRegistrar(cfg, params, m2, impl="plain"), mov1, fx1)))
    numbers["10a"]["k1_slab_err"] = k1_slab_check("10a", sharded, mov1, fx1)
    for label, reg in (("sharded", sharded), ("single", single)):
        peak_reset()
        numbers["10a"][f"{label}_ms"] = timer(lambda: reg.predict_tensors(mov1, fx1), n=1, reps=8,
                                               warmup=2)
        numbers["10a"][f"{label}_peak_mib"] = peak_mib()
    if not rehearsal:
        for label, reg in (("sharded", sharded), ("single", single)):
            ms, ops, rows = device_time(lambda: reg.predict_tensors(mov1, fx1),
                                        f"10a {label} forward")
            copies = sum(r[0] for r in rows if "Cat" in r[2] or "Memcpy" in r[2]
                         or "copy" in r[2].lower())
            numbers["10a"].update({f"{label}_device_ms": ms, f"{label}_device_ops": ops,
                                   f"{label}_copy_device_ms": copies})
        numbers["10a"]["sharding_device_ms"] = (numbers["10a"]["sharded_device_ms"]
                                                - numbers["10a"]["single_device_ms"])
    a = numbers["10a"]
    print(f"#   10a: sharded {a['sharded_ms']:.3f} ms per forward, peak "
          f"{a['sharded_peak_mib']:.1f} MiB; one device {a['single_ms']:.3f} ms, peak {a['single_peak_mib']:.1f} MiB "
          f"({'CUDA events' if cuda else 'host clock, CPU'}); device time of the sharding "
          f"(sharded - single) {a.get('sharding_device_ms', 'not measured')} ms, of the "
          f"concatenations and copies {a.get('sharded_copy_device_ms', 'not measured')} ms "
          f"against {a.get('single_copy_device_ms', 'not measured')} ms", flush=True)
    del sharded, got

    # ---- 10b. {data: 2} on a batch of 3 (padding), {data: 2, space: 2} on 2
    rng = np.random.default_rng(10)
    movs = torch.stack([mov1[0]] + [torch.as_tensor(
        np.roll(mov_np, s, 0) + 0.02 * rng.random(shape).astype(np.float32), device=dev)
        for s in (2, -3) * 3])
    fxs = fx1.expand(len(movs), -1, -1, -1).contiguous()
    numbers["10b"] = {}
    for label, (data, space), n in (("10b data 2, batch 3", (2, 1), 3),
                                    ("10b data 2 x space 2, batch 2", (2, 2), 2)):
        mb = mesh(data, space)
        print(f"# phase {label} on {mb}", flush=True)
        want = predicted(single, movs[:n], fxs[:n])
        reg = ShardedRegistrar(cfg, params, mb)
        kernels.reset_launch_counts()
        got = predicted(reg, movs[:n], fxs[:n])
        key = f"10b_{data}x{space}"
        counts[key] = kernels.launch_counts()
        seen = {**counts[key], **kernels.entry_launch_counts()}
        check(tuple(got["warp"].shape) == tuple(want["warp"].shape), f"{label}: wrong shape")
        print(f"#   {label}: launches {seen}")
        # a batch of 3 is padded to 4: two rows of 2, each a forward on space slabs
        expect = {k: data * v for k, v in single.model.kernel_launches(space).items()}
        if not rehearsal:
            check(seen == expect, f"{label}: launched {seen}, want {expect}")
        numbers["10b"][key] = f2_rule(label, got, want, float(want["warp"].abs().max()))
        numbers["10b"][key].update(kernel_vs_plain(label, got, predicted(
            ShardedRegistrar(cfg, params, mb, impl="plain"), movs[:n], fxs[:n])))
        numbers["10b"][key]["k1_slab_err"] = k1_slab_check(label, reg, movs[:n], fxs[:n])
        del reg, got, want
    # the F2 rule again on the other inputs, for each layout, and on the
    # single device at batch 2 against batch 1: cuDNN's choice for another
    # shape is the source of the difference, with or without sharding
    print(f"# phase 10b repeats: each layout on the other inputs; the single device at batch 2 "
          f"against batch 1", flush=True)
    ulps = {}
    for layout, (data, space), n in (("10a", (1, 2), 1), ("10b_2x1", (2, 1), 3),
                                     ("10b_2x2", (2, 2), 2)):
        reg = ShardedRegistrar(cfg, params, mesh(data, space))
        for i in range(n, len(movs) - n + 1, n):
            m, f = movs[i:i + n], fxs[i:i + n]
            want = predicted(single, m, f)
            errs = f2_rule(f"10b repeat, the {layout} layout on inputs {i}-{i + n - 1}",
                           predicted(reg, m, f), want, float(want["warp"].abs().max()))
            ulps.setdefault(layout, []).append(errs["warp_ulps"])
        del reg, m, f  # views of the inputs would keep them for 10e's peak
    one = [predicted(single, movs[i:i + 1], fxs[i:i + 1]) for i in range(2)]
    want = {k: torch.cat([o[k] for o in one]) for k in ("moved", "warp")}
    numbers["10b"]["single_batch2_vs_batch1"] = f2_rule(
        "10b the single device at batch 2 against batch 1", predicted(single, movs[:2], fxs[:2]),
        want, float(want["warp"].abs().max()))
    numbers["10b"]["repeat_warp_ulps"] = ulps
    print(f"#   10b repeats: warp difference in ulps of the field {json.dumps(ulps)}", flush=True)
    del movs, fxs, one, want

    # ---- 10c. the published widths in int8, {space: 2}
    print(f"# phase 10c: the published widths in int8 with the in-repo sidecar, {{space: 2}} on "
          f"{m2}, against one device; the lazy calibration over slabs", flush=True)
    with open(os.path.join(HERE, "config", "config_inference.json")) as f:
        cfg8 = InferenceConfig.from_dict(dict(json.load(f), quantize="int8"))
    params8 = load_params_any(W256_CKPT, cfg8)
    scales = load_scales(W256_SIDECAR)
    single8 = Registrar(cfg8, params8, device=dev, quant_scales=scales)
    want = predicted(single8, mov1, fx1)
    sharded8 = ShardedRegistrar(cfg8, params8, m2, quant_scales=scales)
    kernels.reset_launch_counts()
    got = predicted(sharded8, mov1, fx1)
    counts["10c"] = kernels.launch_counts()
    seen = {**counts["10c"], **kernels.entry_launch_counts()}
    print(f"#   10c: launches per sharded int8 forward {seen}")
    expect = single8.model.kernel_launches(slabs=2)
    if not rehearsal:
        check(seen == expect, f"10c: launched {seen}, want {expect} (K8 on 9 convs of 2 slabs)")
    # the int8 convs' sums are exact; what is left is the float32 head
    # (cuDNN on a slab's shape may sum in another order) and the bf16
    # integration after it: the F2 rule
    numbers["10c"] = f2_rule("10c", got, want, float(want["warp"].abs().max()))
    numbers["10c"].update(kernel_vs_plain("10c", got, predicted(ShardedRegistrar(
        cfg8, params8, m2, quant_scales=scales, impl="plain"), mov1, fx1)))
    # K8 and its quantize pass at the slab shapes of the int8 convs at half
    # resolution (X / 4 + 2 halo planes): dec_3 512 -> 256 and enc_1,
    # final_0, final_1 256 -> 256, their sums exact
    slab = (1, 4, 4, 4) if rehearsal else (1, shape[0] // 4 + 2, shape[1] // 2, shape[2] // 2)
    for cin, cout in ((512, 256), (256, 256)):
        with torch.inference_mode():
            k8_args = k8_inputs(dev, slab, cin, cout, cin + slab[1])
        numbers["10c"][f"k8_slab_{cin}"] = k8_check(f"on a slab, {cin} -> {cout}", *k8_args)
        del k8_args
    if not rehearsal:  # the plain int8 forward takes seconds on the CPU
        for label, reg in (("sharded", sharded8), ("single", single8)):
            numbers["10c"][f"{label}_ms"] = timer(lambda: reg.predict_tensors(mov1, fx1), n=1,
                                                   reps=5, warmup=1)
        print(f"#   10c: sharded {numbers['10c']['sharded_ms']:.3f} ms per int8 forward, one "
              f"device {numbers['10c']['single_ms']:.3f} ms (CUDA events)", flush=True)
    del sharded8, single8, got, want
    lazy = {}
    for label, reg in (("sharded", ShardedRegistrar(cfg8, params8, m2)),
                       ("single", Registrar(cfg8, params8, device=dev))):
        reg.predict_tensors(mov1, fx1)
        lazy[label] = reg.quant_scales
        del reg
    # the activations are bf16: another cuDNN algorithm on a slab's shape
    # may round the largest of them to its other neighbour, one bf16 ulp
    worst = max(abs(float(lazy["sharded"][k]) - float(v)) / bf16_ulp(float(v))
                for k, v in lazy["single"].items())
    print(f"#   10c: lazy calibration over slabs against one device: {len(lazy['single'])} scales, "
          f"worst {worst:.3f} bf16 ulp of the scale (tolerance 1)")
    check(sorted(lazy["sharded"]) == sorted(lazy["single"]) and worst <= 1.0,
          "10c: the calibration over slabs disagrees with one device's")
    numbers["10c"]["calibration_worst_ulp"] = worst
    del params8

    # ---- 10d. the CLIs with --space 2
    spec = ",".join(str(d) for d in m2.devices.ravel())
    print(f"# phase 10d: pair_registration and bids_two_steps through their argv with --space 2 "
          f"--device {spec}, against the same without the flag", flush=True)
    cfg_path = os.path.join(tmp, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(dict(FLAGSHIP), f)
    numbers["10d"] = {}
    for tag, flags in (("single", ["--device", str(dev)]),
                       ("sharded", ["--space", "2", "--device", spec])):
        d = os.path.join(tmp, "10d", tag)
        os.makedirs(d)
        fxp, movp = os.path.join(d, "fx.nii.gz"), os.path.join(d, "mov.nii.gz")
        nifti.save(nifti.NiftiImage(fx_np, np.eye(4)), fxp)
        nifti.save(nifti.NiftiImage(mov_np, np.eye(4)), movp)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pair_registration(["--model-path", CKPT, "--config-path", cfg_path, "--fx-img-path", fxp,
                           "--mov-img-path", movp, "--fx-img-contrast", "T2w", "--res-dir",
                           os.path.join(d, "res"), "--one-cpu-tf", "False", *flags])
        numbers["10d"][f"pair_{tag}_s"] = time.perf_counter() - t0
        counts[f"10d_pair_{tag}"] = kernels.launch_counts()
        dc = os.path.join(tmp, "10d", f"cascade_{tag}")
        os.makedirs(dc)
        for p in (fxp, movp):
            shutil.copy(p, dc)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bids_two_steps(["--model1-path", CKPT_MODEL1, "--model2-path", CKPT, "--config-path",
                        cfg_path, "--fx-img-path", os.path.join(dc, "fx.nii.gz"),
                        "--mov-img-path", os.path.join(dc, "mov.nii.gz"), "--fx-img-contrast",
                        "T2w", "--one-cpu-tf", "False", *flags])
        numbers["10d"][f"cascade_{tag}_s"] = time.perf_counter() - t0
        counts[f"10d_cascade_{tag}"] = kernels.launch_counts()
    if not rehearsal:
        check(counts["10d_pair_sharded"]["conv3_lrelu_pool"] == 2
              and counts["10d_cascade_sharded"]["conv3_lrelu_pool"] == 4,
              f"10d: want K1 twice a sharded forward: {counts['10d_pair_sharded']}, "
              f"{counts['10d_cascade_sharded']}")
    numbers["10d"]["pair"] = same_output_files("10d pair_registration",
                                               os.path.join(tmp, "10d", "single"),
                                               os.path.join(tmp, "10d", "sharded"))
    numbers["10d"]["cascade"] = same_output_files("10d bids_two_steps",
                                                  os.path.join(tmp, "10d", "cascade_single"),
                                                  os.path.join(tmp, "10d", "cascade_sharded"))
    walls = {k: v for k, v in numbers["10d"].items() if k.endswith("_s")}
    print(f"#   10d: wall s {json.dumps(walls)}")
    n_avail = torch.cuda.device_count() if cuda else 1
    more = InferenceConfig.from_dict(dict(FLAGSHIP, sharding={"data": n_avail + 1}))
    try:
        make_registrar(more, params, device=str(dev) if cuda else ["cpu"])
        fail(f"10d: make_registrar built a layout of {n_avail + 1} devices on {n_avail}")
    except ValueError as e:
        print(f"#   10d: make_registrar with more devices than there are raises: {e}")
    del single

    # ---- 10e. data-parallel training at full width
    labels = 26 if not rehearsal else 6
    print(f"# phase 10e: data-parallel training, {shape}, {labels} labels, batch 2, {{data: 2}} "
          f"on {mesh(2, 1)}, against one device", flush=True)
    base = dict(in_shape=list(shape), num_labels=labels, num_maps=4, batch_size=2,
                enc=[64 if not rehearsal else 8] * 4, dec=[64 if not rehearsal else 8] * 6,
                save_label=False, verbose=0, model_dir=os.path.join(tmp, "10e_models"),
                log_dir=os.path.join(tmp, "10e_logs"), label_dir=os.path.join(tmp, "10e_labels"))
    cfg_t = TrainConfig.from_dict(dict(base, num_devices=2))
    coarse = torch.randint(0, labels, (2, *(max(s // 8, 1) for s in shape)),
                           generator=torch.Generator().manual_seed(10), dtype=torch.uint8)
    maps = coarse.repeat_interleave(8, 1).repeat_interleave(8, 2).repeat_interleave(8, 3)
    maps = maps[:, :shape[0], :shape[1], :shape[2]].contiguous().numpy()
    steps, step_ms, step_peak = {}, {}, {}
    for n in (2, 1):
        trainer = Trainer(cfg_t, mesh=mesh(n, 1))
        trainer.init_state(seed=11)
        src, trg = trainer.put_batch(maps, maps[::-1].copy())
        kernels.reset_launch_counts()
        aux = trainer.train_step(trainer.generator(12), src, trg)
        loss = float(aux["loss"])
        if n == 2:
            counts["10e_step"] = kernels.launch_counts()
            want_step = trainer.step_launches()
        steps[n] = (loss, {k: (p.detach().clone(), p.grad.detach().clone())
                           for k, p in trainer.model.named_parameters()})
        gen = trainer.generator(13)
        peak_reset()
        step_ms[n] = timer(lambda: trainer.train_step(gen, src, trg), n=1, reps=5, warmup=1)
        step_peak[n] = peak_mib()
        del trainer, src, trg, aux
    print(f"#   10e: launches of a 2-replica step {counts['10e_step']}")
    print(f"#   10e: a step at batch 2: {step_ms[2] / 1e3:.4f} s on 2 replicas, peak "
          f"{step_peak[2]:.1f} MiB; {step_ms[1] / 1e3:.4f} s on one device, peak "
          f"{step_peak[1]:.1f} MiB (median of 5, {'CUDA events' if cuda else 'host clock, CPU'})",
          flush=True)
    if not rehearsal:
        check(counts["10e_step"] == want_step,
              f"10e: a 2-replica step launched {counts['10e_step']}, want {want_step}")
    (loss2, p2), (loss1, p1) = steps[2], steps[1]
    # The loss to the JAX package's tolerance. The gradients to the bounds
    # of phase 5's kernel-vs-plain check: bf16 convs at batch 1 a replica
    # against batch 2 sum in another order. The parameters after Adam to
    # the JAX package's rtol 1e-4 / atol 2e-5, all but at most 1e-4 of them:
    # Adam's first step is lr * g / (|g| + eps); most gradients of a fresh
    # model (its flow head starts near zero) lie below eps, where the step is
    # linear in g, so the comparison holds them to about atol * eps / lr; a
    # few near eps, whose bits differ, move by different steps. Each side
    # must be the common start moved by Adam's step of its own gradient.
    # On one card the mesh repeats cuda:0 and both replicas are one model
    # (``replicate`` keeps one copy a device): the two replicas' backwards
    # sum into its gradients, and the copy-and-sum of distinct devices runs
    # only in the CPU tests (``cpu`` and ``cpu:0``)
    loss_tol = 1e-5 + 1e-5 * abs(loss1)
    check(abs(loss2 - loss1) <= loss_tol, f"10e: loss {loss2} against one device's {loss1}")
    worst_g, worst_cos, far, total, worst_adam = 0.0, 1.0, 0, 0, 0.0
    for k, (w1, g1) in p1.items():
        w2, g2 = p2[k]
        rel = float((g2 - g1).abs().max() / g1.abs().max().clamp_min(1e-30))
        cos = float((g1 * g2).sum() / (g1.norm() * g2.norm()).clamp_min(1e-30))
        worst_g, worst_cos = max(worst_g, rel), min(worst_cos, cos)
        step = {i: cfg_t.lr * g / (g.abs() + 1e-8) for i, g in ((1, g1), (2, g2))}
        adam = float(((w2 - w1) - (step[1] - step[2])).abs().max())
        worst_adam = max(worst_adam, adam)
        far += int((~torch.isclose(w2, w1, rtol=1e-4, atol=2e-5)).sum())
        total += g1.numel()
        check(adam <= 1e-6, f"10e: parameter {k} after Adam: {adam:.3e} off the steps of the two "
              f"gradients")
        check(rel <= 0.1 and cos >= 0.995, f"10e: gradient of {k}: {rel:.3e} of max, cos {cos:.5f}")
    check(far <= 1e-4 * total, f"10e: {far} of {total} parameters beyond rtol 1e-4 / atol 2e-5")
    numbers["10e"] = {"loss": loss2, "loss_1dev": loss1, "grad_worst_rel": worst_g,
                      "grad_worst_cos": worst_cos, "params_beyond_tol": far,
                      "params": total, "adam_worst": worst_adam,
                      "step_s": step_ms[2] / 1e3, "step_peak_mib": step_peak[2],
                      "step_1dev_s": step_ms[1] / 1e3, "step_1dev_peak_mib": step_peak[1]}
    print(f"#   10e: loss {loss2:.6f} against one device's {loss1:.6f} (tolerance {loss_tol:.2e}); "
          f"gradients worst {worst_g:.3e} of the leaf's max, cosine >= {worst_cos:.5f} (0.1, "
          f"0.995); parameters beyond rtol 1e-4 / atol 2e-5: {far} of {total} (at most 1e-4 of "
          f"them); each side the start moved by Adam's step of its gradient (worst "
          f"{worst_adam:.3e}, tolerance 1e-6)", flush=True)
    del steps, p1, p2
    spec_t = ",".join(str(d) for d in mesh_devices_of(dev, 2))
    peak_reset()
    kernels.reset_launch_counts()
    out = run_training(TrainConfig.from_dict(dict(base, num_devices=2)), max_steps=2,
                       device=spec_t)
    counts["10e_run"] = kernels.launch_counts()
    check(out["steps"] == 2 and out["trainer"].mesh.shape["data"] == 2
          and all(np.isfinite(r["loss"]) for r in out["history"]),
          f"10e: run_training on 2 replicas: {out['history']}")
    numbers["10e"].update({"run_step_s": out["step_seconds"], "run_peak_mib": peak_mib()})
    print(f"#   10e: run_training num_devices 2 on {spec_t}, 2 steps: s/step "
          f"{[round(s, 4) for s in out['step_seconds']]} (host clock, each ending in a read of "
          f"the loss), peak {numbers['10e']['run_peak_mib']:.1f} MiB; launches {counts['10e_run']}",
          flush=True)
    del out

    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 10: {numbers['total_s']:.1f} s of its budget of {PHASE10_BUDGET_S} s",
          flush=True)
    return counts, numbers


PHASE11_BUDGET_S = 90  # of the script's 1200 s
BENCH_SHAPE = (192, 192, 192)  # bench.py:36
# bench_torch.py's lines with no --arch, in this order (bench.py:199-204)
BENCH_SPECS = (("infer256", "", "registered_192cube_enc256_pairs_per_sec"),
               ("infer256", "int8", "registered_192cube_enc256_pairs_per_sec_int8"),
               ("train64", "", "registered_192cube_vol_pairs_per_sec"))
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
# the JAX package's adoption gate of int8 (benchmarks/quantize_quality_probe.py:
# 142-145): int8's held-out Dice and NMI at most this far below bf16's
INT8_DICE_GAP, INT8_NMI_GAP = 0.005, 0.002


def bench_run(rehearsal):
    """11a's run of ``bench_torch.py`` with its default flags: on the card a
    process of its own, through its argv and stdout; in the rehearsal its
    ``main`` at 16^3, one block of one forward. Returns the exit code, the
    standard output and the standard error."""
    if not rehearsal:
        r = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py")], cwd=HERE,
                           capture_output=True, text=True, timeout=PHASE11_BUDGET_S)
        return r.returncode, r.stdout, r.stderr
    import contextlib
    import io

    import bench_torch

    out, err = io.StringIO(), io.StringIO()
    saved, bench_torch.SHAPE = bench_torch.SHAPE, (16, 16, 16)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench_torch.main(["--device", "cpu", "--iters", "1", "--blocks", "1"])
    finally:
        bench_torch.SHAPE = saved
    return rc, out.getvalue(), err.getvalue()


def bench_kernels_vs_plain(dev, rehearsal):
    """11a: the kernels at the shapes the bench gives them, against their
    plain versions (phase 2's tolerances): K1 on (1, 192^3, 2) to 64 and to
    256 channels, K2's fused step on the 96^3 field (exact), K3 writing 192^3
    from 96^3, K8 at 96^3, 256 and 512 to 256 (exact); then each of the
    bench's three models through the kernels against the same through their
    plain versions on a synthetic 192^3 pair (phase 3's limits)."""
    import numpy as np
    import torch

    import bench_torch
    from multimodal_registration_torch.ops.conv_pool import conv3_lrelu_pool
    from multimodal_registration_torch.ops.warp import self_warp_add_batch, warp_up2x_batch

    shape = (16, 16, 16) if rehearsal else BENCH_SHAPE
    half = tuple(s // 2 for s in shape)
    rng = np.random.default_rng(111)
    errs = {}
    x = torch.as_tensor(rng.normal(size=(1, *shape, 2)).astype(np.float32), device=dev).bfloat16()
    for cout in (64, 256):
        w = torch.as_tensor(rng.normal(scale=0.2, size=(cout, 2, 3, 3, 3)).astype(np.float32),
                            device=dev)
        b = torch.as_tensor(rng.normal(scale=0.1, size=(cout,)).astype(np.float32), device=dev)
        with torch.inference_mode():
            p = conv3_lrelu_pool(x, w, b, impl="plain")
            errs[f"K1 -> {cout}"] = compare(
                f"11a K1 conv3_lrelu_pool {tuple(x.shape)} -> {cout} (tol 1 bf16 ulp of max|out|)",
                conv3_lrelu_pool(x, w, b), p, bf16_ulp(float(p.float().abs().max())))
        del p
    del x
    phi = smooth_field(half, 3.0, 112, dev)
    with torch.inference_mode():
        errs["K2 fused"] = compare(
            f"11a K2 self_warp_add bf16 payload, {tuple(phi.shape)}",
            self_warp_add_batch(phi, torch.bfloat16),
            self_warp_add_batch(phi, torch.bfloat16, impl="plain"), 0.0, exact=True)
        img = torch.as_tensor(rng.random((1, *shape, 1)).astype(np.float32), device=dev)
        errs["K3"] = compare(f"11a K3 warp_up2x f32, {tuple(img.shape)} from {tuple(phi.shape)}",
                             warp_up2x_batch(img, phi), warp_up2x_batch(img, phi, impl="plain"),
                             1e-5)
    del phi, img
    for cin in (256, 512):
        errs[f"K8 {cin} -> 256"] = k8_check(f"11a, {cin} -> 256", *k8_inputs(dev, (1, *half), cin,
                                                                            256, 113 + cin))
    fx_np, mov_np = synthetic_pair(shape)
    mov_t = torch.as_tensor(mov_np, device=dev)[None, ..., None]
    fx_t = torch.as_tensor(fx_np, device=dev)[None, ..., None]
    for arch, quantize, metric in BENCH_SPECS:
        model = bench_torch.bench_model(arch, quantize, shape, 1, dev)
        with torch.inference_mode():
            out_k = model(mov_t, fx_t)
            out_p = model(mov_t, fx_t, impl="plain")
        check(all(bool(torch.isfinite(out_k[k]).all()) for k in ("moved", "warp")),
              f"11a {metric}: the forward is not finite")
        check(tuple(out_k["warp"].shape) == (1, *half, 3), f"11a {metric}: warp's shape")
        d_warp = float((out_k["warp"] - out_p["warp"]).abs().max())
        d_moved = float((out_k["moved"] - out_p["moved"]).abs().max())
        print(f"#   11a {metric} model on a synthetic {shape} pair, kernels vs plain: warp "
              f"{d_warp:.3e} voxel (tol 0.1), moved {d_moved:.3e} (tol 0.05); max|warp| "
              f"{float(out_p['warp'].abs().max()):.3f}", flush=True)
        check(d_warp <= 0.1 and d_moved <= 0.05, f"11a {metric}: the kernel forward disagrees "
              "with the plain forward")
        errs[f"{metric} warp"], errs[f"{metric} moved"] = d_warp, d_moved
        del model, out_k, out_p
    return errs


def int8_quality(dev, rehearsal):
    """11b: the w256 checkpoint in bf16 and in int8 on three held-out pairs
    (``tools/learn_check.py``: three maps of its bank at 160x160x192, 26
    labels, made on the device, two syntheses each), Dice (labels warped
    by K2 nearest) and NMI from ``learn_check.evaluate``, under the JAX
    package's gate. The int8 arm starts without scales: a ``Registrar``
    calibrates them on the first pair it predicts, as every entry point
    does. The rehearsal runs a random init of width 64 at 16^3, ungated."""
    import numpy as np
    import torch

    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import (
        Registrar, load_params_any, vxm_config_from)
    from multimodal_registration_torch.models.vxm_dense import VxmDense
    from multimodal_registration_torch.tools import learn_check as lc
    from multimodal_registration_torch.train.trainer import engine_config_from, init_like_flax_

    labels = 26
    shape = (16, 16, 16) if rehearsal else (160, 160, 192)
    with open(os.path.join(HERE, "config", "config_inference.json")) as f:
        settings = json.load(f)
    if rehearsal:
        settings = dict(settings, enc=[64] * 4, dec=[64] * 6)
    cfg = InferenceConfig.from_dict(settings)
    cfg8 = InferenceConfig.from_dict(dict(settings, quantize="int8"))
    if rehearsal:
        model = VxmDense(vxm_config_from(cfg), device="cpu")
        init_like_flax_(model, 0)
        params = model.state_dict()
    else:
        params = load_params_any(W256_CKPT, cfg)
    tcfg = lc.check_config(shape, labels, warm=True)
    pairs = lc.held_out_pairs(lc.map_bank(tcfg, dev, num_maps=lc.NUM_PAIRS),
                              engine_config_from(tcfg),
                              torch.Generator(device=dev).manual_seed(lc.SEED_PAIRS), dev)
    base = lc.identity(pairs, labels)
    regs = {"bf16": Registrar(cfg, params, device=dev), "int8": Registrar(cfg8, params, device=dev)}
    mov0, _, fx0, _ = pairs[0]
    regs["int8"].predict_tensors(mov0[None], fx0[None])  # the lazy calibration on pair 0
    scales = regs["int8"].quant_scales
    check(scales is not None and len(scales) == 9, f"11b: the lazy calibration gave {scales}")
    arms, flows = {}, {}
    for name, reg in regs.items():
        per = [lc.evaluate(reg.model, [p], labels) for p in pairs]
        with torch.inference_mode():
            flows[name] = [reg.model(m[None, ..., None], f[None, ..., None])["flow_fullres"][0]
                           for m, _, f, _ in pairs]
        arms[name] = {"dice": float(np.mean([e["dice"] for e in per])),
                      "nmi": float(np.mean([e["nmi"] for e in per])),
                      "per_pair_dice": [e["dice"] for e in per],
                      "per_pair_nmi": [e["nmi"] for e in per]}
    diffs = [(a - b).abs() for a, b in zip(flows["bf16"], flows["int8"])]
    agree = {"max": float(max(float(d.max()) for d in diffs)),
             "mean": float(np.mean([float(d.mean()) for d in diffs]))}
    gap = {"dice": arms["bf16"]["dice"] - arms["int8"]["dice"],
           "nmi": arms["bf16"]["nmi"] - arms["int8"]["nmi"]}
    with open(os.path.join(HERE, "benchmarks", "quantize_quality_results.json")) as f:
        jax_ref = json.load(f)
    print(f"#   11b: identity Dice {base['dice']:.4f}, NMI {base['nmi']:.4f} ({shape}, {labels} "
          f"labels, {len(pairs)} held-out pairs)")
    for name, arm in arms.items():
        print(f"#   11b {name}: Dice {arm['dice']:.4f} (pairs "
              f"{', '.join(f'{d:.4f}' for d in arm['per_pair_dice'])}), NMI {arm['nmi']:.4f} "
              f"(pairs {', '.join(f'{n:.4f}' for n in arm['per_pair_nmi'])}); the JAX package on "
              f"its pairs: Dice {jax_ref['arms'][name]['dice']}, NMI {jax_ref['arms'][name]['nmi']}")
    print(f"#   11b gate: int8 Dice {gap['dice']:+.4f} below bf16 (at most {INT8_DICE_GAP}), NMI "
          f"{gap['nmi']:+.4f} below (at most {INT8_NMI_GAP}); the JAX package: "
          f"{jax_ref['gate']['dice_gap']}, {jax_ref['gate']['nmi_gap']}")
    print(f"#   11b flow agreement int8 vs bf16 (full res): max {agree['max']:.4f}, mean "
          f"{agree['mean']:.5f} voxel; the JAX package: max {jax_ref['flow_agreement_vox']['max']}, "
          f"mean {jax_ref['flow_agreement_vox']['mean']}", flush=True)
    if not rehearsal:
        check(gap["dice"] <= INT8_DICE_GAP and gap["nmi"] <= INT8_NMI_GAP,
              f"11b: int8 fails the JAX package's quality gate: {gap}")
    return {"identity": base, "arms": arms, "gap": gap, "flow_agreement_vox": agree,
            "scales": {k: float(v) for k, v in scales.items()}}


def bench_phase(dev, rehearsal):
    """Phase 11: 11a ``bench_torch.py`` with its default flags (its three
    lines at 192^3: the contract of ``bench.py``), its kernels against their
    plain versions at its shapes; 11b int8 held to the JAX package's quality
    gate against bf16. Returns the launch counts of each (11a's from the
    bench's own process: every forward of its three lines) and the phase's
    numbers."""
    import re

    import torch

    import bench_torch
    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.models.vxm_dense import VxmDense

    t_phase = time.perf_counter()
    counts, numbers = {}, {}
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the bench's process shares the card
    print("# phase 11a: bench_torch.py with its default flags (infer256 bf16, infer256 int8, "
          f"train64; {'16^3 on the CPU' if rehearsal else f'{BENCH_SHAPE}, its own process'})",
          flush=True)
    rc, stdout, stderr = bench_run(rehearsal)
    for line in stderr.splitlines():
        if line.startswith("#"):
            print(f"#   bench: {line[1:].strip()}")
    check(rc == 0, f"11a: bench_torch.py exited with {rc}: {stderr[-3000:]}")
    out = stdout.splitlines()
    check(len(out) == len(BENCH_SPECS), f"11a: bench_torch.py printed {len(out)} lines: {stdout!r}")
    lines = []
    for text, (_, _, metric) in zip(out, BENCH_SPECS):
        try:
            line = json.loads(text)
        except ValueError:
            fail(f"11a: not a JSON line: {text!r}")
        print(f"#   11a line: {text}")
        check(isinstance(line, dict) and list(line) == BENCH_KEYS and line["metric"] == metric
              and line["unit"] == "pairs/s" and math.isfinite(line["value"]) and line["value"] > 0
              and isinstance(line["vs_baseline"], (int, float)),
              f"11a: want {metric} with keys {BENCH_KEYS}, unit pairs/s and a value > 0: {line}")
        lines.append(line)
    per_forward = [json.loads(m) for m in re.findall(r"^# launches per forward: (\{.*\})$",
                                                     stderr, re.M)]
    in_all = [json.loads(m) for m in re.findall(r"^# launches in all: (\{.*\})$", stderr, re.M)]
    best = [tuple(map(float, m)) for m in re.findall(
        r"^# best ([0-9.]+) ms/forward, peak memory ([0-9.]+) MiB$", stderr, re.M)]
    check(len(per_forward) == len(in_all) == len(BENCH_SPECS),
          f"11a: the bench's stderr lacks its launch counts: {stderr[-2000:]}")
    counts["11a"] = {k: sum(c[k] for c in in_all) for k in in_all[0]}
    wants = [VxmDense(bench_torch.model_config(arch, quantize), device="meta").kernel_launches()
             for arch, quantize, _ in BENCH_SPECS]
    if not rehearsal:
        check(len(best) == len(BENCH_SPECS), "11a: the bench's stderr lacks its best times")
        for (_, _, metric), got, want in zip(BENCH_SPECS, per_forward, wants):
            check(got == {k: want[k] for k in got},
                  f"11a {metric}: a forward launched {got}, want {want}")
    numbers["11a"] = {
        "lines": lines, "per_forward_launches": per_forward,
        "best_ms": [b[0] for b in best], "peak_mib": [b[1] for b in best],
        "blocks_ms": [float(v) for v in re.findall(r"^# block \d+: ([0-9.]+) ms/iter$", stderr,
                                                   re.M)],
        "bench_s": time.perf_counter() - t_phase}
    numbers["11a"]["kernels_vs_plain"] = bench_kernels_vs_plain(dev, rehearsal)
    numbers["11a_s"] = time.perf_counter() - t_phase

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print("# phase 11b: int8 against bf16 on held-out pairs under the JAX package's quality gate "
          "(Dice within 0.005, NMI within 0.002)", flush=True)
    kernels.reset_launch_counts()
    numbers["11b"] = int8_quality(dev, rehearsal)
    counts["11b"] = kernels.launch_counts()
    with open(os.path.join(HERE, "config", "config_inference.json")) as f:
        launched("11b", counts["11b"], forward_launches(dict(json.load(f), quantize="int8")),
                 rehearsal)
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 11: {numbers['total_s']:.1f} s of its budget of {PHASE11_BUDGET_S} s "
          f"(11a {numbers['11a_s']:.1f} s, the bench's process "
          f"{numbers['11a']['bench_s']:.1f} s)", flush=True)
    return counts, numbers


PHASE12_BUDGET_S = 240  # of the script's 1200 s


def quality_phase(dev, rehearsal, tmp):
    """Phase 12: the batch pipeline's registration quality on held-out
    synthetic subjects (``tools/pipeline_quality.py``, the port's
    ``benchmarks/pipeline_parity_run.py`` and ``twostep_parity_run.py``): 12a
    the three pipeline arms (``learned_ref``, w256 bf16, w256 int8 with the
    in-repo sidecar) on the tree of maps seed 777, 12b the five two-step
    arms on the tree of maps seed 888 with the moving contrast rigidly
    displaced. Every arm launched K1, K2 and K3 (K8 in int8) and each
    synthesis K6; sub-01 of 12a's ``learned_ref`` arm is registered again
    through the plain versions (phase 3's limits against the pipeline's
    field and moved image, and the gate's folding on the plain field); the
    tool's gates hold. The rehearsal runs the tool's ``--quick`` (48^3, tiny
    models that do not register) and holds no gate. Returns the launch
    counts of 12a and 12b and the phase's numbers."""
    import glob

    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.evalx.jacobian import folding_summary
    from multimodal_registration_torch.infer.config import InferenceConfig
    from multimodal_registration_torch.infer.register import Registrar, load_params_any, register
    from multimodal_registration_torch.tools import pipeline_quality as pq
    from multimodal_registration_torch.utils import nifti

    t_phase = time.perf_counter()
    counts, numbers = {}, {}
    n_subjects = 2 if rehearsal else 3
    snapshot = {p: (open(p, "rb").read() if p.endswith(".json") else os.path.getmtime(p))
                for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def arms_launched(label, part, want=None):
        launched(f"{label} synthesis", part["synthesis"]["launches"],
                 {"warp_labels_soft_hard": 1}, rehearsal)
        for name, arm in part["arms"].items():
            launched(f"{label} {name}", arm["launches"],
                     want or forward_launches(arm["config"]), rehearsal)

    print(f"# phase 12a: run_batch (--opt-affine, min_sc_dice {pq.MIN_SC_DICE}) in the arms "
          f"{pq.PIPELINE_ARMS} on {n_subjects} held-out subjects (maps seed "
          f"{pq.PIPELINE_MAPS_SEED}){', --quick' if rehearsal else ''}", flush=True)
    kernels.reset_launch_counts()
    part_a = pq.pipeline_arms(os.path.join(tmp, "12a"), dev, quick=rehearsal,
                              n_subjects=n_subjects)
    counts["12a"] = kernels.launch_counts()
    numbers["12a_s"] = time.perf_counter() - t_phase
    arms_launched("12a", part_a)

    # sub-01 of the learned_ref arm through the plain versions
    arm = part_a["arms"]["learned_ref"]
    sub = part_a["subjects"][0]
    cfg = InferenceConfig.from_dict(arm["config"])
    reg_p = Registrar(cfg, load_params_any(arm["model_path"], cfg), device=dev, impl="plain")
    pdir = os.path.join(tmp, "12a_plain")
    os.makedirs(pdir)
    for c in ("T2w", "T1w"):
        shutil.copy(os.path.join(tmp, "12a", "data", sub, "anat", f"{sub}_{c}.nii.gz"), pdir)
    t0 = time.perf_counter()
    out_p = register(cfg, reg_p, os.path.join(pdir, f"{sub}_T2w.nii.gz"),
                     os.path.join(pdir, f"{sub}_T1w.nii.gz"), fx_contrast="T2w")
    plain_s = time.perf_counter() - t0
    work = os.path.join(tmp, "12a", "out_learned_ref", "data_processed", sub)
    d = {}
    for k, name in (("warp", f"{sub}_T1w_proc_field_to_T2w.nii.gz"),
                    ("moved", f"{sub}_T1w_proc_reg_to_T2w.nii.gz")):
        found = sorted(glob.glob(os.path.join(work, "*", name)))
        check(bool(found), f"12a: the pipeline wrote no {name} for {sub}")
        a = nifti.load(found[0]).get_fdata()
        d[k] = float(np.abs(a - nifti.load(os.path.join(pdir, name)).get_fdata()).max())
    folding = folding_summary(out_p["warp"], device=dev)["percentage_negative_detJa"]
    kernel_folding = arm["summary"]["folding_percent"][0]
    numbers["12a_plain"] = {"subject": sub, **d, "folding_percent_plain": folding,
                            "folding_percent_kernels": kernel_folding, "register_s": plain_s}
    print(f"#   12a plain path, {sub} of learned_ref: warp {d['warp']:.3e} voxel (tol 0.1), moved "
          f"{d['moved']:.3e} (tol 0.05) from the pipeline's; folding {folding:.6f} % on the plain "
          f"field, {kernel_folding:.6f} % on the kernels' (gate <= {pq.GATE_FOLDING_PERCENT} %); "
          f"register() {plain_s:.2f} s", flush=True)
    check(d["warp"] <= 0.1 and d["moved"] <= 0.05, "12a: the pipeline disagrees with the plain path")
    check(folding <= pq.GATE_FOLDING_PERCENT, "12a: the plain path folds beyond the gate")
    del reg_p

    t0 = time.perf_counter()
    print(f"# phase 12b: run_batch in the arms {tuple(pq.TWOSTEP_ARMS)} on {n_subjects} held-out "
          f"subjects (maps seed {pq.TWOSTEP_MAPS_SEED}), the moving contrast rigidly displaced",
          flush=True)
    kernels.reset_launch_counts()
    part_b = pq.twostep_arms(os.path.join(tmp, "12b"), dev, quick=rehearsal,
                             n_subjects=n_subjects)
    counts["12b"] = kernels.launch_counts()
    numbers["12b_s"] = time.perf_counter() - t0
    arms_launched("12b", part_b, forward_launches(FLAGSHIP))

    for label, part in (("12a", part_a), ("12b", part_b)):
        numbers[label] = {
            "synthesis_s": part["synthesis"]["seconds"],
            "s_per_subject": {k: a["s_per_subject"] for k, a in part["arms"].items()},
            "summary": (part["summary"] if label == "12b" else
                        {k: a["summary"] for k, a in part["arms"].items()}),
            "fallback": {k: a["used_affine_fallback"] for k, a in part["arms"].items()}}
        print(f"#   {label} s/subject: {json.dumps(numbers[label]['s_per_subject'])} "
              f"(synthesis {part['synthesis']['seconds']:.1f} s)", flush=True)
        print(f"#   {label} summary: {json.dumps(numbers[label]['summary'])}", flush=True)
    gates = pq.gates(part_a, part_b)
    numbers["gates"] = gates
    for name, ok in gates.items():
        print(f"#   gate {name}: {'held' if ok else 'FAILED'}")
    if not rehearsal:
        check(all(gates.values()), f"12: gates failed: {[k for k, ok in gates.items() if not ok]}")
    after = {p: (open(p, "rb").read() if p.endswith(".json") else os.path.getmtime(p))
             for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}
    check(after == snapshot, "phase 12 changed something under benchmarks/")
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 12: {numbers['total_s']:.1f} s of its budget of {PHASE12_BUDGET_S} s "
          f"(12a {numbers['12a_s']:.1f} s, 12b {numbers['12b_s']:.1f} s)", flush=True)
    return counts, numbers


PHASE13_BUDGET_S = 180  # of the script's 1200 s
# 13a: tools/train_bench.py's runs, each in a process of its own:
# (label, --batch, --width)
TRAIN_BENCH_RUNS = (("flagship b1", 1, 0), ("flagship b2", 2, 0), ("w256 b1", 1, 256))
TRAIN_BENCH_ARGS = ("--iters", "6", "--blocks", "3")
LOSS_FLAT = 0.02  # 13a: final_loss at most this far above the warm-up step's
STEP_AGREE = 0.25  # 13b: train_breakdown's full step within this share of 13a's s/step


def train_bench_run(batch, width, rehearsal):
    """One run of ``tools/train_bench.py``: on the card a process of its own,
    through its argv; in the rehearsal its ``main`` at 16^3, 4 labels, width 8
    for 256, one block of one step. Returns the exit code, stdout and stderr."""
    args = ["--batch", str(batch), "--width", str(width)]
    if not rehearsal:
        r = subprocess.run([sys.executable, "-m", "multimodal_registration_torch.tools.train_bench",
                            *TRAIN_BENCH_ARGS, *args], cwd=HERE, capture_output=True, text=True,
                           timeout=PHASE13_BUDGET_S)
        return r.returncode, r.stdout, r.stderr
    import contextlib
    import io

    from multimodal_registration_torch.tools import train_bench as tb

    out, err = io.StringIO(), io.StringIO()
    saved = tb.SHAPE, tb.NUM_LABELS
    tb.SHAPE, tb.NUM_LABELS = (16, 16, 16), 4
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            tb.main(["--iters", "1", "--blocks", "1", "--batch", str(batch),
                     "--width", str(8 if width else 0), "--device", "cpu"])
    finally:
        tb.SHAPE, tb.NUM_LABELS = saved
    return 0, out.getvalue(), err.getvalue()


def train_bench_record(label, batch, width, rehearsal):
    """13a's check of one ``train_bench`` run: exit code 0, one stdout line
    with ``train_bench.py``'s keys, a positive rate, a finite final loss at
    most ``LOSS_FLAT`` above the warm-up step's; on the card each step's
    launches as counted and the peak memory. Returns its numbers."""
    import re

    from multimodal_registration_torch.tools import train_bench as tb
    from multimodal_registration_torch.train.trainer import Trainer

    rc, stdout, stderr = train_bench_run(batch, width, rehearsal)
    for line in stderr.splitlines():
        print(f"#     {label}: {line}")
    check(rc == 0, f"13a {label}: train_bench exited {rc}: {stderr[-2000:]}")
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    check(len(lines) == 1, f"13a {label}: want one stdout line, got {lines}")
    rec = json.loads(lines[0])
    print(f"#   13a {label}: {lines[0]}", flush=True)
    want_metric = tb.metric_name(batch, 8 if rehearsal and width else width,
                                 (16, 16, 16) if rehearsal else tb.SHAPE)
    check(list(rec) == list(tb.KEYS) and rec["metric"] == want_metric
          and rec["unit"] == "steps/s" and math.isfinite(rec["value"]) and rec["value"] > 0
          and math.isfinite(rec["final_loss"]),
          f"13a {label}: want {want_metric} with keys {tb.KEYS}, a rate > 0, a finite loss: {rec}")
    warm = float(re.search(r"^# warm-up step: loss (\S+)$", stderr, re.M).group(1))
    per_step = json.loads(re.search(r"^# launches per step: (\{.*\})$", stderr, re.M).group(1))
    blocks = [float(v) for v in re.findall(r"^# block \d+: (\S+) s/step", stderr, re.M)]
    peak = re.search(r"^# best \S+ s/step, peak memory (\S+) MiB$", stderr, re.M)
    n_steps = 1 + len(blocks) * (6 if not rehearsal else 1)
    numbers = {"metric": rec["metric"], "steps_per_s": rec["value"],
               "sec_per_step": rec["sec_per_step"], "final_loss": rec["final_loss"],
               "warmup_loss": warm, "blocks_s": blocks, "launches_per_step": per_step,
               "steps": n_steps, "peak_mib": float(peak.group(1)) if peak else None}
    want = Trainer(tb.train_config(batch, width), device="cpu").step_launches()
    if not rehearsal:
        check(per_step == want, f"13a {label}: a step launched {per_step}, want {want}")
        check(len(blocks) == 3 and peak is not None and numbers["peak_mib"] > 0,
              f"13a {label}: the stderr lacks its blocks or its peak memory")
        check(rec["final_loss"] <= warm + LOSS_FLAT,
              f"13a {label}: the loss rose from {warm} to {rec['final_loss']} "
              f"(allowed {LOSS_FLAT})")
    return numbers


def k4_w256_check(dev, shape, timer, rehearsal):
    """13a: K4 at the w256 step's pool shapes (C = 256 on the full grid and
    each level below), bf16, windows with ties, against its plain version
    exactly; each shape's time beside its bound, plain version and the
    backward of ``F.max_pool3d``. Returns the rows."""
    import torch
    import torch.nn.functional as F

    from multimodal_registration_torch.ops.pool import max_pool_2x_bwd

    C = 256 if not rehearsal else 8
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, grid = [], tuple(shape)
    for level in range(4):
        half = tuple(s // 2 for s in grid)
        x = (torch.randint(-6, 7, (1, *grid, C), generator=gen, device=dev) * 0.25).bfloat16()
        g = torch.randn((1, *half, C), generator=gen, device=dev).bfloat16()
        err = compare(f"13a K4 max_pool_2x_bwd bf16 equal {tuple(x.shape)}",
                      max_pool_2x_bwd(x, g, "equal"), max_pool_2x_bwd(x, g, "equal", impl="plain"),
                      0.0, exact=True)
        xc = x.permute(0, 4, 1, 2, 3)
        row = measure(timer, f"max_pool_2x_bwd C={C} {grid}",
                      bound((2 * x.numel() + g.numel()) * 2, x.numel() * 3, FP32_FLOPS),
                      lambda: max_pool_2x_bwd(x, g, "equal"),
                      lambda: max_pool_2x_bwd(x, g, "equal", impl="plain"),
                      backward_call(lambda v: F.max_pool3d(v, 2, 2), [xc],
                                    g.permute(0, 4, 1, 2, 3)), n=5)
        rows.append({"shape": list(x.shape), "max_abs_err": err, "ms": row["ms"],
                     "device_ms": row["device_ms"], "device_ops": row["device_ops"],
                     "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
                     "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
                     "library_device_ms": row["library_device_ms"]})
        print(f"#   13a K4 {tuple(x.shape)}: {row['ms']:.4f} ms wrapper, device "
              f"{row['device_ms']} ms, bound {row['bound'][0]:.4f} ms ({row['bound'][1]}), "
              f"plain {row['plain_ms']:.4f} ms, max_pool3d backward {row['library_ms']:.4f} ms",
              flush=True)
        del x, g, xc
        grid = half
    return rows


def _positive(label, rows: dict, keys):
    bad = {k: rows[k] for k in keys if not (math.isfinite(rows[k]) and rows[k] > 0)}
    check(not bad, f"{label}: rows not finite and positive: {bad}")


def _finite(label, rows: dict, keys):
    bad = {k: rows[k] for k in keys if not math.isfinite(rows[k])}
    check(not bad, f"{label}: rows not finite: {bad}")


def measurement_phase(dev, shape, timer, rehearsal):
    """Phase 13: the training step's and the batch pipeline's measurement
    tools (``multimodal_registration_torch/tools/``). 13a ``train_bench``
    (flagship batch 1 and 2, w256 batch 1) in processes of their own, the
    w256 step's fixed batch and K4 at 256 channels against their plain
    versions; 13b the attribution tools in this process; 13d
    ``pipeline_throughput``. Returns the launch counts of
    13a (the bench processes'), 13b and 13d, the phase's numbers and K4's
    rows at 256 channels."""
    import glob

    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.tools import (
        bwd_breakdown, fwd_breakdown, pipeline_throughput, synth_breakdown,
        train_breakdown, train_profile, train_sol)
    from multimodal_registration_torch.train.config import TrainConfig
    from multimodal_registration_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    counts, numbers = {}, {}
    snapshot = {p: (open(p, "rb").read() if p.endswith(".json") else os.path.getmtime(p))
                for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}

    # ---- 13a. train_bench, w256 against the plain path, K4 at 256 channels
    print(f"# phase 13a: tools/train_bench.py {' '.join(TRAIN_BENCH_ARGS)} in processes of "
          f"their own: {', '.join(r[0] for r in TRAIN_BENCH_RUNS)}", flush=True)
    numbers["13a"] = {}
    counts["13a"] = dict.fromkeys(kernels.launch_counts(), 0)
    for label, batch, width in TRAIN_BENCH_RUNS:
        rec = numbers["13a"][label] = train_bench_record(label, batch, width, rehearsal)
        for k, v in rec["launches_per_step"].items():
            counts["13a"][k] += v * rec["steps"]
    numbers["13a_bench_s"] = time.perf_counter() - t_phase
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    w256 = 256 if not rehearsal else 16
    print(f"# phase 13a: the w256 step's fixed batch (enc/dec {w256}, {shape}) through the kernels "
          "against the plain versions", flush=True)
    cfg = TrainConfig.from_dict(dict(in_shape=list(shape), num_labels=26 if not rehearsal else 6,
                                     enc=[w256] * 4, dec=[w256] * 6, batch_size=1))
    trainer = Trainer(cfg, device=dev)
    _, batch = fixed_batch(trainer, shape)
    fixed_batch_check("13a w256 fixed batch", trainer, batch)
    del trainer, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    k4_rows = k4_w256_check(dev, shape, timer, rehearsal)
    numbers["13a_s"] = time.perf_counter() - t_phase
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 13b. the attribution tools, in this process
    t0 = time.perf_counter()
    print(f"# phase 13b: train_breakdown and train_profile (flagship and enc/dec {w256}), "
          f"bwd_breakdown, synth_breakdown, train_sol at {shape}; fwd_breakdown train and "
          f"infer256 at "
          f"{(16, 16, 16) if rehearsal else BENCH_SHAPE}", flush=True)

    def emit(tool):
        def out(text):
            for line in str(text).splitlines():
                if line.strip():
                    print(f"#   13b {tool}: {line}")
        return out

    kernels.reset_launch_counts()
    b13 = {}
    for label, width in (("train_breakdown", 0), ("train_breakdown_w256", w256)):
        b13[label] = res = train_breakdown.run(small=rehearsal, device=dev, emit=emit(label),
                                               width=width)
        _positive(f"13b {label}", res, train_breakdown.ROWS)
        _finite(f"13b {label}", res, train_breakdown.DERIVED)
    b13["bwd_breakdown"] = bw = bwd_breakdown.run(small=rehearsal, device=dev,
                                                  emit=emit("bwd_breakdown"))
    _positive("13b bwd_breakdown", bw, [f"{c}_{k}_ms" for c in bwd_breakdown.COMPONENTS
                                        for k in ("fwd", "fwd_bwd")])
    _finite("13b bwd_breakdown", bw, [f"{c}_bwd_ms" for c in bwd_breakdown.COMPONENTS])
    b13["synth_breakdown"] = sb = synth_breakdown.run(small=rehearsal, device=dev,
                                                      emit=emit("synth_breakdown"))
    _positive("13b synth_breakdown", sb, [f"cum_{s}_ms" for s in synth_breakdown.STAGES]
              + ["aug_pair_ms", "synth_pair_ms"])
    _finite("13b synth_breakdown", sb, [f"delta_{s}_ms" for s in synth_breakdown.STAGES])
    profs = {}
    for label, width in (("train_profile", 0), ("train_profile_w256", w256)):
        prof = train_profile.run(3, rehearsal, device=dev, emit=emit(label), width=width)
        if not rehearsal and not prof["on_device"]:  # no device record: see device_time
            print(f"#   13b {label}: the trace held no device record; traced again", flush=True)
            prof = train_profile.run(3, rehearsal, device=dev, emit=emit(label), width=width)
        profs[label] = prof
        b13[label] = {k: prof[k] for k in ("category_ms_per_step", "total_device_ms_per_step",
                                           "on_device")}
        _positive(f"13b {label}", prof["category_ms_per_step"], prof["category_ms_per_step"])
    sol = train_sol.run(small=rehearsal, device=dev, emit=emit("train_sol"))
    b13["train_sol"] = sol
    for row in sol["rows"]:
        _positive(f"13b train_sol {row['stage']}", row, ("ms", "floor_ms"))
    fwd_shape = (16, 16, 16) if rehearsal else BENCH_SHAPE
    for arch in ("train", "infer256"):
        b13[f"fwd_breakdown_{arch}"] = fb = fwd_breakdown.run(
            arch, 0, fwd_shape, device=dev, emit=emit(f"fwd_breakdown {arch}"))
        _positive(f"13b fwd_breakdown {arch}", fb, fwd_breakdown.ROWS)
    counts["13b"] = kernels.launch_counts()
    numbers["13b"] = b13
    for label, run13a in (("train_breakdown", "flagship b1"), ("train_breakdown_w256", "w256 b1")):
        bench_ms = numbers["13a"][run13a]["sec_per_step"] * 1e3
        gap = abs(b13[label]["full_step_ms"] - bench_ms) / bench_ms
        print(f"#   13b {label} full_step_ms {b13[label]['full_step_ms']:.3f} against 13a's "
              f"{run13a} {bench_ms:.3f} ms/step: {gap:.3f} apart (allowed {STEP_AGREE})",
              flush=True)
        check(rehearsal or gap <= STEP_AGREE,
              f"13b: {label}'s full step disagrees with train_bench's {run13a}")
    for label, prof in profs.items():
        found = sorted(k for k in prof["category_ms_per_step"] if k.startswith("K"))
        print(f"#   13b {label} names {found} ({'device' if prof['on_device'] else 'host'} "
              "time)", flush=True)
        check(rehearsal or (prof["on_device"]
                            and all(k in found for k in ("K2", "K4", "K5", "K6", "K7"))),
              f"13b: the {label} trace does not name K2, K4-K7: {found}")
    numbers["13b_s"] = time.perf_counter() - t0

    # ---- 13d. pipeline_throughput
    t0 = time.perf_counter()
    n_subjects = 2 if rehearsal else 3
    configs = ("default", "noprefetch", "jobs2")
    print(f"# phase 13d: tools/pipeline_throughput.py --subjects {n_subjects} --configs "
          f"{','.join(configs)}{' --quick' if rehearsal else ''}", flush=True)
    kernels.reset_launch_counts()
    doc = pipeline_throughput.run(configs, n_subjects, quick=rehearsal, device=dev,
                                  emit=lambda text: None)
    counts["13d"] = kernels.launch_counts()
    launched("13d", counts["13d"], forward_launches(FLAGSHIP), rehearsal)
    numbers["13d"] = doc
    for name, c in doc["configs"].items():
        print(f"#   13d {name}: ok {c['ok']}, {c['subjects_per_min']:.4f} subjects/min "
              f"(steady {c['subjects_per_min_steady']}), wall {c['wall_s']:.2f} s, per subject "
              f"{[round(s, 3) for s in c['per_subject_s']]}", flush=True)
        print(f"#   13d {name} phases (s): {json.dumps(c['phase_totals_s'])}")
        check(c["ok"] and len(c["per_subject_s"]) == n_subjects,
              f"13d {name}: a subject failed or is missing")
    print(f"#   13d dataset built in {doc['dataset_build_s']:.2f} s", flush=True)
    numbers["13d_s"] = time.perf_counter() - t0

    after = {p: (open(p, "rb").read() if p.endswith(".json") else os.path.getmtime(p))
             for p in glob.glob(os.path.join(HERE, "benchmarks", "*"))}
    check(after == snapshot, "phase 13 changed something under benchmarks/")
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 13: {numbers['total_s']:.1f} s of its budget of {PHASE13_BUDGET_S} s "
          f"(13a {numbers['13a_s']:.1f} s, its bench processes {numbers['13a_bench_s']:.1f} s; "
          f"13b {numbers['13b_s']:.1f} s; 13d {numbers['13d_s']:.1f} s)", flush=True)
    return counts, numbers, k4_rows


PHASE14_BUDGET_S = 180  # of the script's 1200 s
# 14c-14e: (steps of leg 1, steps of leg 2) warm from learned_ref; w256 steps;
# learned_model1 steps
STUDY_LEGS, STUDY_W256_STEPS, STUDY_M1_STEPS = (200, 100), 20, 200
STUDY_TINY = dict(in_shape=[16, 16, 16], num_labels=4, num_maps=2)  # the CPU rehearsal
DICE_HOLD = 0.01  # 14c, 14e: Dice after the steps within this of step 0's (9b's gate)


def counted(fn, total, entries):
    """``fn()`` with the launch counts from zero, the card synchronised
    after it; returns ``(result, counts, entry counts)``. The counts are
    added to ``total`` and the entry counts to ``entries``."""
    import torch

    from multimodal_registration_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    c, e = kernels.launch_counts(), kernels.entry_launch_counts()
    for acc, new in ((total, c), (entries, e)):
        for k, v in new.items():
            acc[k] = acc.get(k, 0) + v
    return out, c, e


def lines_of(label):
    """An ``emit`` that prints a tool's lines under ``label``."""
    return lambda text: print(f"#   {label}: {text}", flush=True)


def benchmarks_digest() -> str:
    """One sha256 over every file under ``benchmarks/`` (names and bytes)."""
    import hashlib

    h = hashlib.sha256()
    root = os.path.join(HERE, "benchmarks")
    for dirpath, dirnames, files in os.walk(root):
        dirnames.sort()
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                for block in iter(lambda: f.read(1 << 22), b""):
                    h.update(block)
    return h.hexdigest()


def _all_finite(label, doc):
    """Every number in ``doc`` (nested dicts and lists) finite."""
    def walk(v):
        if isinstance(v, dict):
            return all(walk(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(walk(x) for x in v)
        return not isinstance(v, float) or math.isfinite(v)
    check(walk(doc), f"{label}: a value is not finite: {json.dumps(doc)}")


def studies_phase(dev, rehearsal, tmp):
    """Phase 14: the studies ``benchmarks/`` held only in JAX, run through the
    port's tools (``multimodal_registration_torch/tools/``): 14a ``ablate``,
    14b ``unet_bwd_probe``, 14c-14d ``learn_ref_workload`` (two legs; the
    published widths), 14e ``learn_model1_workload``, 14f
    ``cascade_folding_probe`` and ``cascade_smoothing_sweep``, 14g
    ``opt_affine_rotation_study``. Nothing under ``benchmarks/`` changes.
    Returns ``{"14": launch counts of the phase}`` and its numbers (with
    ``entries``, the phase's launches by C entry)."""
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.models.unet import Unet
    from multimodal_registration_torch.tools import (
        ablate, cascade_folding_probe as cfp, cascade_smoothing_sweep as css,
        learn_model1_workload as lm1, learn_ref_workload as lrw,
        opt_affine_rotation_study as oars, unet_bwd_probe)

    t_phase = time.perf_counter()
    digest = benchmarks_digest()
    total = dict.fromkeys(kernels.launch_counts(), 0)
    numbers = {"entries": {}}

    tally = (total, numbers["entries"])

    # ---- 14a. ablate at 192^3
    t0 = time.perf_counter()
    shape_a = (16, 16, 16) if rehearsal else ablate.SHAPE
    print(f"# phase 14a: tools/ablate.py at {shape_a}", flush=True)
    res, _, _ = counted(lambda: ablate.run(shape_a, dev, emit=lines_of("14a ablate")), *tally)
    _positive("14a ablate", res, ablate.ROWS)
    per_call = {}
    with torch.inference_mode():
        for row, (fn, x) in ablate.chains(shape_a, dev).items():
            _, c, e = counted(lambda: fn(x), *tally)
            per_call[row] = {k: v for k, v in {**c, **e}.items() if v}
    print(f"#   14a launches per chain call: {json.dumps(per_call)}", flush=True)
    fwd = forward_launches(FLAGSHIP)  # ablate's U-Net is the flagship's: its K1, K10, K11
    want = {"unet_convs_ms": {k: fwd[k] for k in ("conv3_lrelu_pool", "conv3_lrelu_pool_launch",
                                                  "up_cat", "up_cat_launch", "bias_lrelu",
                                                  "bias_lrelu_launch")},
            "integrate5_halfres_ms": {"warp_trilinear": 5, "self_warp_add_launch": 5},
            "warp_fullres_ms": {"warp_trilinear": 1, "warp_launch": 1},
            "rescale_2x_ms": {}}
    check(rehearsal or per_call == want,
          f"14a: launches per chain call {per_call}, want K1 x1, K10 x3, K11 x9 (U-Net), "
          "K2's fused step x5 (integrate), K2 x1 (warp), none (rescale)")
    numbers["14a"] = {"rows": res, "launches_per_call": per_call,
                      "s": time.perf_counter() - t0}

    # ---- 14b. unet_bwd_probe 6 at 160x160x192
    t0 = time.perf_counter()
    small = rehearsal
    print(f"# phase 14b: tools/unet_bwd_probe.py 6{' --small' if small else ''}", flush=True)
    res, _, _ = counted(lambda: unet_bwd_probe.run(1 if small else 6, small, dev,
                                                   emit=lines_of("14b unet_bwd_probe")), *tally)
    check(not any(k.endswith("_error") for k in res), f"14b: a section failed: {res}")
    _positive("14b unet_bwd_probe", res, [f"{s}_{k}_ms" for s in unet_bwd_probe.SECTIONS
                                          for k in ("fwd", "fwd_bwd")])
    _finite("14b unet_bwd_probe", res, [f"{s}_bwd_ms" for s in unet_bwd_probe.SECTIONS])
    # K4's launches in one forward and backward of the sections with pools
    shape_b = tuple(res["shape"])
    x2 = torch.randn((1, *shape_b, 2), device=dev)
    torch.manual_seed(0)
    k4 = {}
    for name, model in (
            ("unet_full", Unet(2, (64,) * 4, (64,) * 6, nb_upsample_skips=1, device=dev)),
            ("first_convpool", unet_bwd_probe.ConvLeaky(2, (64,), "xla", device=dev)),
            ("first_convrpool", unet_bwd_probe.ConvLeaky(2, (64,), "reshape", device=dev))):
        params = list(model.parameters())
        _, c, _ = counted(lambda: torch.autograd.grad(model(x2).float().sum(), params), *tally)
        k4[name] = c["max_pool_2x_bwd"]
    del x2
    print(f"#   14b K4 launches per forward and backward: {k4}", flush=True)
    check(rehearsal or k4 == {"unet_full": 4, "first_convpool": 0, "first_convrpool": 1},
          f"14b: K4 launches {k4}, want 4 (unet_full), 0 (F.max_pool3d), 1 (max_pool_2x)")
    numbers["14b"] = {"rows": res, "k4_launches": k4, "s": time.perf_counter() - t0}

    # ---- 14c-14e. the trajectory workloads
    cfg_over = STUDY_TINY if rehearsal else None
    legs = (2, 1) if rehearsal else STUDY_LEGS
    out_dir = os.path.join(tmp, "learn_workloads")

    def above_identity(label, point, base):
        ok = point["dice"] > base["dice"] and point["nmi"] > base["nmi"]
        print(f"#   {label}: step 0 Dice {point['dice']} NMI {point['nmi']} against the "
              f"identity's {base['dice']} / {base['nmi']}", flush=True)
        check(rehearsal or ok, f"{label}: step 0 is not above the identity")

    t0 = time.perf_counter()
    print(f"# phase 14c: tools/learn_ref_workload.py {legs[0]} {os.path.basename(CKPT)}, then "
          f"{legs[1]} resuming its own checkpoint, --out-dir in a temp directory", flush=True)
    spec = lrw.ref_spec(0)
    log1, _, _ = counted(lambda: lrw.run(legs[0], CKPT, 0, out_dir, dev, cfg_over,
                                         emit=lines_of("14c leg 1")), *tally)
    warm2 = lrw.default_warm(spec, out_dir)
    check(warm2 == os.path.join(out_dir, spec.ckpt), "14c: leg 2 would not resume")
    log, _, _ = counted(lambda: lrw.run(legs[1], warm2, 0, out_dir, dev, cfg_over,
                                        emit=lines_of("14c leg 2")), *tally)
    traj = log["trajectory"]
    steps = [p["step"] for p in traj]
    check(steps == [0, legs[0], legs[0] + legs[1]], f"14c: trajectory steps {steps}")
    above_identity("14c", traj[0], log["identity"])
    drift = traj[-1]["dice"] - traj[0]["dice"]
    print(f"#   14c Dice at step {steps[-1]} {traj[-1]['dice']} against step 0's "
          f"{traj[0]['dice']} ({drift:+.4f}, allowed -{DICE_HOLD}); s/step "
          f"{traj[1]['sec_per_step']} / {traj[2]['sec_per_step']}", flush=True)
    check(rehearsal or drift >= -DICE_HOLD, "14c: Dice fell after the warm start")
    _all_finite("14c", log)
    numbers["14c"] = {"record": log, "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    w_steps = 2 if rehearsal else STUDY_W256_STEPS
    print(f"# phase 14d: tools/learn_ref_workload.py {w_steps} {os.path.basename(W256_CKPT)} "
          "--width 256", flush=True)
    log, _, _ = counted(lambda: lrw.run(w_steps, W256_CKPT, 256, out_dir, dev, cfg_over,
                                        emit=lines_of("14d")), *tally)
    traj = log["trajectory"]
    check([p["step"] for p in traj] == [0, w_steps] and traj[-1]["loss"] is not None
          and math.isfinite(traj[-1]["loss"]), f"14d: trajectory {traj}")
    above_identity("14d", traj[0], log["identity"])
    _all_finite("14d", log)
    numbers["14d"] = {"record": log, "s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    m_steps = 2 if rehearsal else STUDY_M1_STEPS
    print(f"# phase 14e: tools/learn_model1_workload.py {m_steps} "
          f"{os.path.basename(CKPT_MODEL1)}", flush=True)
    log, _, _ = counted(lambda: lm1.run(m_steps, CKPT_MODEL1, out_dir, dev, cfg_over,
                                        emit=lines_of("14e")), *tally)
    traj = log["trajectory"]
    check([p["step"] for p in traj] == [0, m_steps], f"14e: trajectory {traj}")
    for regime in lm1.SPEC.regimes:
        above = traj[0][regime]["dice"] > log["identity"][regime]["dice"]
        print(f"#   14e {regime}: step 0 Dice {traj[0][regime]['dice']} NMI "
              f"{traj[0][regime]['nmi']} against the identity's {log['identity'][regime]}; "
              f"step {m_steps} Dice {traj[-1][regime]['dice']}", flush=True)
        check(rehearsal or above, f"14e: {regime} step 0 Dice not above the identity's")
    drift = traj[-1]["smooth"]["dice"] - traj[0]["smooth"]["dice"]
    check(rehearsal or drift >= -DICE_HOLD, f"14e: smooth Dice fell by {-drift:.4f}")
    _all_finite("14e", log)
    numbers["14e"] = {"record": log, "s": time.perf_counter() - t0}
    check(sorted(os.listdir(out_dir)) == sorted(
        [spec.results, spec.ckpt, lrw.ref_spec(256).results, lrw.ref_spec(256).ckpt,
         lm1.SPEC.results, lm1.SPEC.ckpt]),
        f"14c-14e wrote other files into --out-dir: {os.listdir(out_dir)}")

    # ---- 14f. the cascade folding probe and the smoothing sweep on sub-02
    t0 = time.perf_counter()
    print("# phase 14f: tools/cascade_folding_probe.py, then tools/cascade_smoothing_sweep.py "
          f"(sigmas {list(css.SIGMAS)}), sub-02{' (--quick)' if rehearsal else ''}", flush=True)
    probe, _, _ = counted(lambda: cfp.run(rehearsal, 1, dev), *tally)
    print(f"#   14f probe: {json.dumps(probe)}", flush=True)
    _all_finite("14f probe", probe)
    fold = probe["folding_pct_exported"]
    gap = abs(fold["int_compose_numpy_vxm_check"] - fold["int_compose(reference semantics)"])
    check(gap <= 0.01, f"14f: the numpy compose's folding is {gap} points from compose_fields'")
    sweep, _, _ = counted(lambda: css.run(1, css.SIGMAS, dev, emit=lines_of("14f sweep"),
                                          quick=rehearsal), *tally)
    _all_finite("14f sweep", sweep)
    rows = {r["sigma_vox_at_svf_grid"]: r for r in sweep["rows"]}
    for sigma in (1.5, 3.0):
        check(rows[sigma]["fold_warp1_only"] <= rows[0.0]["fold_warp1_only"],
              f"14f: step 1's folding at sigma {sigma} above sigma 0's")
    for sigma, r in rows.items():
        check(r["dice_int_compose"] >= rows[0.0]["dice_int_compose"] - DICE_HOLD,
              f"14f: Dice of the int compose at sigma {sigma} fell by more than {DICE_HOLD}")
    numbers["14f"] = {"probe": probe, "sweep": sweep, "s": time.perf_counter() - t0}

    # ---- 14g. the opt-affine rotation study against the committed record
    t0 = time.perf_counter()
    print("# phase 14g: tools/opt_affine_rotation_study.py against "
          "benchmarks/opt_affine_rotation_results.json", flush=True)
    study = oars.run(emit=lambda row: None)
    with open(os.path.join(HERE, "benchmarks", "opt_affine_rotation_results.json")) as f:
        committed = json.load(f)
    worst = {"dice": 0.0, "angle": 0.0}
    for g, w in zip(study["cases"], committed["cases"], strict=True):
        check(g["case"] == w["case"] and set(g) == set(w), f"14g: case {g['case']}")
        for k in w:
            if k.startswith("dice"):
                worst["dice"] = max(worst["dice"], abs(g[k] - w[k]))
            elif k.startswith("residual"):
                worst["angle"] = max(worst["angle"], abs(g[k] - w[k]))
    print(f"#   14g largest differences to the committed file: Dice {worst['dice']}, angle "
          f"{worst['angle']} deg; summary {json.dumps(study['summary'])}", flush=True)
    check(worst["dice"] <= 0.002 and worst["angle"] <= 0.05,
          "14g: the rotation study disagrees with the committed results")
    check(all(study["summary"][k] is v for k, v in committed["summary"].items()
              if isinstance(v, bool)), "14g: the summary's booleans differ")
    numbers["14g"] = {"summary": study["summary"], "worst": worst,
                      "s": time.perf_counter() - t0}

    check(benchmarks_digest() == digest, "phase 14 changed something under benchmarks/")
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 14: {numbers['total_s']:.1f} s of its budget of {PHASE14_BUDGET_S} s ("
          + ", ".join(f"{k} {numbers[k]['s']:.1f} s" for k in
                      ("14a", "14b", "14c", "14d", "14e", "14f", "14g")) + ")", flush=True)
    check(rehearsal or numbers["total_s"] <= PHASE14_BUDGET_S,
          f"phase 14 took {numbers['total_s']:.1f} s, over its budget of {PHASE14_BUDGET_S} s")
    return {"14": total}, numbers



PHASE15_BUDGET_S = 150  # of the script's 1200 s
PROBE_STEPS = 1000  # 15a: each arm, as 9a's one arm (the JAX probe's 3000 cut for time)
PROBE_TINY = dict(in_shape=[16, 16, 16], num_labels=4)  # the CPU rehearsal
# 15c: the batch of 2's warp against the single pair's on the probe's initial
# weights (fields of 1e-4 voxel), in bf16 ulps of the field: twice the largest
# reading, 1.973 ulp (PERF.md section 6); f2_rule says why its 1 ulp
# does not hold there
BATCH2_ULPS = 4


def probes_phase(dev, rehearsal, fwd3):
    """Phase 15: the last probes ``benchmarks/`` held only in JAX and the
    port's ``entry()``: 15a ``svf4_learn_probe``, 15b ``conv_probe``, 15c
    ``pair_interleave_probe``, 15d ``entry.py::entry()``. ``fwd3`` is phase 3's
    ``(moving, fixed, outputs)``. Nothing under ``benchmarks/`` changes and
    nothing is caught. Returns the launch counts of each sub-phase and the
    phase's numbers (with ``entries``, the phase's launches by C entry)."""
    import dataclasses

    import numpy as np
    import torch

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.entry import CFG as ENTRY_CFG, SHAPE as ENTRY_SHAPE, entry
    from multimodal_registration_torch.models.vxm_dense import VxmDense
    from multimodal_registration_torch.models.weights import params_from_jax
    from multimodal_registration_torch.tools import (
        conv_probe as cp, pair_interleave_probe as pip, svf4_learn_probe as s4)
    from multimodal_registration_torch.tools.timing import ms_per_call

    t_phase = time.perf_counter()
    digest = benchmarks_digest()
    counts = {}
    numbers = {"entries": {}}

    # ---- 15a. svf_int_res 2 against 4, trained from scratch at 96^3
    t0 = time.perf_counter()
    steps = 2 if rehearsal else PROBE_STEPS
    over = PROBE_TINY if rehearsal else None
    cfgs = {r: s4.probe_config(False, r, over) for r in s4.ARMS}
    print(f"# phase 15a: tools/svf4_learn_probe.py {steps}: arms svf_int_res {list(s4.ARMS)}, "
          f"{tuple(cfgs[2].in_shape)}, {cfgs[2].num_labels} labels", flush=True)
    (record, state), _, _ = counted(lambda: s4.probe(steps, False, dev, emit=lines_of("15a"),
                                                     over=over),
                                    counts.setdefault("15a", {}), numbers["entries"])
    a, b = (dataclasses.asdict(state["configs"][r]) for r in s4.ARMS)
    differ = sorted(k for k in a if a[k] != b[k])
    check(differ == ["svf_int_res"] and (a["svf_int_res"], b["svf_int_res"]) == (2, 4),
          f"15a: the arms' configurations differ in {differ}")
    ident = record["identity"]
    last = {r: record["arms"][str(r)][-1] for r in s4.ARMS}
    for r in s4.ARMS:
        print(f"#   15a arm {r}: step {last[r]['step']} Dice {last[r]['dice']} NMI "
              f"{last[r]['nmi']} against the identity's {ident['dice']} / {ident['nmi']}; "
              f"{last[r]['sec_per_step']} s/step with the evaluation", flush=True)
        check(rehearsal or (last[r]["dice"] > ident["dice"] and last[r]["nmi"] > ident["nmi"]),
              f"15a: arm {r} did not learn: {last[r]}")
    gap = {k: round(last[4][k] - last[2][k], 4) for k in ("dice", "nmi")}
    with open(os.path.join(HERE, "benchmarks", "svf4_learn_results.json")) as f:
        jax_ref = json.load(f)
    ref = {r: jax_ref["arms"][r][-1] for r in jax_ref["arms"]}
    print(f"#   15a gap, arm 4 less arm 2 (not a gate): Dice {gap['dice']:+.4f}, NMI "
          f"{gap['nmi']:+.4f}; the JAX package's TPU record "
          f"(benchmarks/svf4_learn_results.json, other pairs, {jax_ref['steps']} steps; a "
          f"reference, not a target): Dice {ref['2']['dice']} / {ref['4']['dice']}, identity "
          f"{jax_ref['identity']['dice']}", flush=True)
    # the trained arm 4 through the kernels against their plain versions
    mov, _, fx, _ = state["pairs"][0]
    with torch.inference_mode():
        model4 = state["trainers"][4].model
        out_k = model4(mov[None, ..., None], fx[None, ..., None])
        out_p = model4(mov[None, ..., None], fx[None, ..., None], impl="plain")
    plain = kernel_vs_plain("15a trained arm 4, held-out pair 0", out_k, out_p)
    c = counts["15a"]
    if not rehearsal:
        check(all(c[k.name] >= 1 for k in kernels.KERNELS if k.name != "conv3_int8"),
              f"15a: a kernel of the training and evaluation path was not launched: {c}")
    print(f"#   15a launches (both arms, {steps} steps each, their evaluations): {c}", flush=True)
    numbers["15a"] = {"record": record, "gap": gap, **plain, "s": time.perf_counter() - t0}
    del state, model4, out_k, out_p, mov, fx

    # ---- 15b. the U-Net's convs on cuDNN, per level
    t0 = time.perf_counter()
    cases = cp.CASES
    if rehearsal:
        cases = tuple((lb, tuple(x // 12 for x in sh), ci, co, st) for lb, sh, ci, co, st in cases)
    print(f"# phase 15b: tools/conv_probe.py, {len(cases)} cases in bf16 (cuDNN)", flush=True)
    rows, c, _ = counted(lambda: cp.run(dev, emit=lines_of("15b"), cases=cases),
                         counts.setdefault("15b", {}), numbers["entries"])
    check(len(rows) == len(cp.CASES), f"15b: {len(rows)} rows")
    for r in rows:
        tflops = r["flops"] / r["seconds"] / 1e12
        print(f"#   15b {r['case']}: {r['seconds'] * 1e3:.4f} ms, {tflops:.2f} TFLOP/s, "
              f"{tflops / cp.PEAK_TFLOPS:.4f} of the {cp.PEAK_TFLOPS:.0f} TFLOP/s bf16 peak",
              flush=True)
        check(r["seconds"] > 0 and 0 < tflops <= cp.PEAK_TFLOPS,
              f"15b: {r['case']} reads {tflops} TFLOP/s, outside (0, {cp.PEAK_TFLOPS}]")
    check(not any(c.values()), f"15b: the conv probe launched the port's kernels: {c}")
    numbers["15b"] = {"rows": [{k: r[k] for k in ("case", "ms", "tflops", "seconds", "flops")}
                               for r in rows], "s": time.perf_counter() - t0}

    # ---- 15c. two pairs on two streams
    t0 = time.perf_counter()
    tally = (counts.setdefault("15c", {}), numbers["entries"])
    shape_c, guard_c = ((16, 16, 16),) * 2 if rehearsal else (pip.SHAPE, pip.GUARD_SHAPE)
    print(f"# phase 15c: tools/pair_interleave_probe.py at {shape_c}, the guard at {guard_c}; "
          f"the batch of 2 also on {os.path.basename(CKPT)}'s weights", flush=True)
    model, vols, rng = pip.build(shape_c, dev)
    diff = pip.guard(model, rng, dev, guard_c)
    print(f"#   15c guard: the staged U -> T against model(...) at {guard_c}: {diff} "
          f"(tol {pip.GUARD_ATOL})", flush=True)
    fns = pip.arms(model, vols, dev)

    def singles():
        """Each pair's single forward and the largest field value."""
        out = [pip.stage_t(model, m, pip.stage_u(model, m, f)) for m, f in (vols[:2], vols[2:])]
        return out, max(float(w.abs().max()) for _, w in out)

    def agree_with(label, got, want, field_max, ulps):
        """The F2 rule on each pair's outputs, and whether they are equal."""
        errs = []
        for i, ((gm, gw), (wm, ww)) in enumerate(zip(got, want)):
            e = f2_rule(f"{label} pair {'AB'[i]}", {"moved": gm, "warp": gw},
                        {"moved": wm, "warp": ww}, field_max, ulps)
            e["exact"] = bool(torch.equal(gm, wm) and torch.equal(gw, ww))
            errs.append(e)
        return errs

    # every arm on the model that is timed below: the staged arms run the
    # single pair's kernels and convs on the same shapes, so they equal it bit
    # for bit; the batch of 2 runs cuDNN at another batch size (see f2_rule)
    per_pair, agree = {}, {}
    fwd_want = {k: v for k, v in model.kernel_launches().items() if v}
    with torch.inference_mode():
        want, field_max = singles()
        for name, fn in fns.items():
            out, c, e = counted(fn, *tally)
            n = 1 if name == "batch2_ms_per_pair" else len(out)
            per_pair[name] = {k: v / n for k, v in {**c, **e}.items() if v}
            check(rehearsal or per_pair[name] == fwd_want,
                  f"15c {name}: launches {per_pair[name]} per {'call' if n == 1 else 'pair'}, "
                  f"want {fwd_want}")
            if name == "single_pair_ms":
                out = out + [want[1]]
            batch2 = name == "batch2_ms_per_pair"
            agree[name] = agree_with(f"15c {name}", out, want, field_max,
                                     BATCH2_ULPS if batch2 else 1)
            check(batch2 or all(x["exact"] for x in agree[name]),
                  f"15c {name}: a pair's outputs differ from its single forward's")
    print(f"#   15c launches per pair (per call for the batch of 2): {json.dumps(per_pair)}; "
          "equal to the single pair bit for bit: "
          + json.dumps({k: [e["exact"] for e in v] for k, v in agree.items()}), flush=True)
    res, _, _ = counted(lambda: pip.time_arms(fns, dev, emit=lines_of("15c")), *tally)
    check(all(res[k] > 0 for k in pip.ARMS), f"15c: a row is not positive: {res}")
    print(f"#   15c speedup of two interleaved pairs over 2x a single one (not a gate): "
          f"{res['speedup_interleave_vs_2x_single']}; the JAX package's TPU record "
          "(benchmarks/pair_interleave_probe_results.json; a reference, not a target): 0.955",
          flush=True)
    # where a pair's wall goes: the device's busy time (torch.profiler) against
    # the wall (CUDA events, no profiler), and the device operations a pair
    prof = {}
    with torch.inference_mode():
        for name, n in (("single_pair_ms", 1), ("batch2_ms_per_pair", 2)):
            if rehearsal:
                break
            (busy, ops, _), _, _ = counted(lambda: device_time(fns[name]), *tally)
            wall = ms_per_call(dev, fns[name], pip.ITERS, pip.WARMUP, pip.BLOCKS)
            prof[name] = {"busy_ms_per_pair": busy / n, "wall_ms_per_pair": wall / n,
                          "idle_share": max(0.0, 1 - busy / wall), "device_ops_per_pair": ops / n}
            print(f"#   15c profile, {name}: device busy {busy / n:.4f} ms of {wall / n:.4f} ms "
                  f"wall a pair, idle share {prof[name]['idle_share']:.4f}, {ops / n:g} device "
                  "operations a pair", flush=True)
    # the batch of 2 on the learned weights, whose fields are voxels
    with np.load(CKPT) as z:
        model.load_state_dict({k: v.to(dev) for k, v in params_from_jax(dict(z), pip.CFG).items()})
    with torch.inference_mode():
        want, field_max = singles()
        out, _, _ = counted(fns["batch2_ms_per_pair"], *tally)
        agree["batch2_learned_ref"] = agree_with(f"15c batch2 on {os.path.basename(CKPT)}", out,
                                                 want, field_max, 1)
    numbers["15c"] = {"guard": diff, "results": res, "launches_per_pair": per_pair,
                      "agree": agree, "profile": prof, "s": time.perf_counter() - t0}
    del model, vols, fns, want, out

    # ---- 15d. entry()
    t0 = time.perf_counter()
    print("# phase 15d: multimodal_registration_torch/entry.py::entry()", flush=True)
    fn, (params, mov0, fx0) = entry(dev)
    if rehearsal:  # the plain versions at 160x160x192 take minutes on the CPU
        mov0, fx0 = mov0[:, :32, :32, :48], fx0[:, :32, :32, :48]
    tally = (counts.setdefault("15d", {}), numbers["entries"])
    (moved, warp), c, e = counted(lambda: fn(params, mov0, fx0), *tally)
    want_shapes = ((1, *mov0.shape[1:4], 1), (1, *(s // 2 for s in mov0.shape[1:4]), 3))
    check(tuple(moved.shape) == want_shapes[0] and tuple(warp.shape) == want_shapes[1],
          f"15d: fn gave {tuple(moved.shape)} and {tuple(warp.shape)}, want {want_shapes}")
    check(rehearsal or want_shapes == ((1, 160, 160, 192, 1), (1, 80, 80, 96, 3)),
          f"15d: example inputs {tuple(mov0.shape)}, want {ENTRY_SHAPE}")
    check(bool(torch.isfinite(moved).all() and torch.isfinite(warp).all()),
          "15d: fn's outputs are not finite")
    launched = {k: v for k, v in {**c, **e}.items() if v}
    want = VxmDense(ENTRY_CFG, device="meta").kernel_launches()
    check(rehearsal or {**c, **e} == want, f"15d: fn launched {launched}, want {want}")
    fn_ms = ms_per_call(dev, lambda: fn(params, mov0, fx0), *((1, 1, 1) if rehearsal else (10, 2, 3)))
    mov_t, fx_t, out3 = fwd3
    with np.load(CKPT) as z:
        ckpt = {k: v.to(dev) for k, v in params_from_jax(dict(z), ENTRY_CFG).items()}
    (moved, warp), _, _ = counted(lambda: fn(ckpt, mov_t, fx_t), *tally)
    d = {"moved": float((moved - out3["moved"]).abs().max()),
         "warp": float((warp - out3["warp"]).abs().max())}
    print(f"#   15d: fn(*example_args) {want_shapes[0]} and {want_shapes[1]}, finite, launches "
          f"{launched}, {fn_ms:.4f} ms a call (ms_per_call); with "
          f"{os.path.basename(CKPT)}'s weights on phase 3's pair against phase 3's forward: "
          f"max_abs_diff {d} (want 0, exactly)", flush=True)
    check(torch.equal(moved, out3["moved"]) and torch.equal(warp, out3["warp"]),
          f"15d: fn with the checkpoint's weights differs from phase 3's forward: {d}")
    numbers["15d"] = {"ms": fn_ms, "launches": launched, "vs_phase3": d,
                      "s": time.perf_counter() - t0}
    del fn, params, ckpt, moved, warp

    check(benchmarks_digest() == digest, "phase 15 changed something under benchmarks/")
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 15: {numbers['total_s']:.1f} s of its budget of {PHASE15_BUDGET_S} s ("
          + ", ".join(f"{k} {numbers[k]['s']:.1f} s" for k in ("15a", "15b", "15c", "15d"))
          + ")", flush=True)
    check(rehearsal or numbers["total_s"] <= PHASE15_BUDGET_S,
          f"phase 15 took {numbers['total_s']:.1f} s, over its budget of {PHASE15_BUDGET_S} s")
    return counts, numbers


PHASE16_BUDGET_S = 150  # of the script's 1200 s
# (label, (B, X, Y, Z), C): the flagship head and the published widths' at
# the half grid of 160x160x192, the tiles of use_subvol (80x80x96, batches of
# 4), and one X slab of {space: 2} with its two halo planes
FLOW_HEAD_SHAPES = (("flagship", (1, 80, 80, 96), 64), ("w256", (1, 80, 80, 96), 256),
                    ("tiles", (4, 40, 40, 48), 64), ("space2_slab", (1, 42, 80, 96), 64))
FLOW_HEAD_ENTRIES = ("flow_head_fwd_launch", "flow_head_dgrad_launch",
                     "flow_head_wgrad_launch", "flow_head_wgrad_finish_launch")


def flow_head_phase(dev, timer, rehearsal, results, timing):
    """Phase 16: K9, the flow head's float32 conv C -> 3 (``ops/flow_head.py``),
    its three entries against their plain versions (the same formulas tap by
    tap) in float64 at :data:`FLOW_HEAD_SHAPES`: each element within 4 *
    sqrt(N) * 2**-24 of the root of the sum of its N squared terms
    (``references_and_limits``), the bf16 input gradient also 1 bf16 ulp;
    a weight and bias gradient of the cotangent rounded to bf16, and a forward
    of the weights rounded to bf16, beyond it (a record that the limit sees
    such a loss of precision); each entry's ms, device
    ms and operations beside its bound (float32 FMAs at FP32_FLOPS; bytes at
    3.35 TB/s), its plain version and the library's float32 conv that the
    head ran before (``library_ms``: the conv on ``feat.float()``, its input
    gradient through the cast, its weight and bias gradients); then the
    launches of one flagship forward (K9 x1) and of one loss-and-backward of
    the flagship model (one of each entry). Returns its launch counts and
    numbers."""
    import torch
    import torch.nn.functional as F

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.device import full_fp32_convs
    from multimodal_registration_torch.models.unet import _ncdhw, _ndhwc
    from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
    from multimodal_registration_torch.ops import flow_head as fh

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    numbers, counts = {"shapes": {}}, {}
    print("# phase 16: K9, the flow head (float32 conv C -> 3, forward and both gradients)",
          flush=True)

    def library(feat, w, b):  # the head as it ran before K9
        with full_fp32_convs():
            return _ndhwc(F.conv3d(_ncdhw(feat.float()), w, b, padding=1)).contiguous()

    def inference(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    fwd_entry = fh._forward if cuda else fh.flow_head_plain
    dgrad_entry = fh._dgrad if cuda else fh.flow_head_dgrad_plain
    wgrad_entry = fh._wgrad if cuda else fh.flow_head_wgrad_plain
    gen = torch.Generator(device=dev).manual_seed(16)
    for label, shape, C in FLOW_HEAD_SHAPES:
        if rehearsal:
            shape = (shape[0], 6, 4, 8 if label != "tiles" else 6)
        feat = torch.randn((*shape, C), generator=gen, device=dev).bfloat16()
        w = torch.randn((3, C, 3, 3, 3), generator=gen, device=dev) * 0.05
        b = torch.randn((3,), generator=gen, device=dev)
        cot = torch.randn((*shape, 3), generator=gen, device=dev)

        def grads(head):
            leaves = [x.detach().clone().requires_grad_() for x in (feat, w, b)]
            out = head(*leaves)
            out.backward(cot)
            return [out.detach()] + [x.grad for x in leaves]

        def k9_grads():  # the Function on the card; the plain versions in a rehearsal
            if cuda:
                return grads(fh.flow_head_conv)
            return [fwd_entry(feat, w, b), dgrad_entry(cot, w, feat.dtype),
                    *wgrad_entry(feat, cot)]

        def share_of_limit(got, want, limit):
            return float(((got.double() - want).abs() / limit.clamp_min(1e-300)).max())

        kernels.reset_launch_counts()
        got = k9_grads()
        if cuda:
            torch.cuda.synchronize()
        entries = kernels.entry_launch_counts()
        check(rehearsal or entries == dict.fromkeys(FLOW_HEAD_ENTRIES, 1),
              f"16 {label}: a forward and backward launched {entries}, want each entry once")
        want, limits = fh.references_and_limits(feat, w, b, cot)
        row = {"shape": [*shape, C], "err": {}, "share_of_limit": {}}
        for name, k, p, lim in zip(("fwd", "dgrad", "wgrad", "bias"), got, want, limits):
            err, share = float((k.double() - p).abs().max()), share_of_limit(k, p, lim)
            row["err"][name], row["share_of_limit"][name] = err, share
            print(f"#   16 {label} {name}: max_abs_err {err:.3e} against float64; the largest "
                  f"error {share:.3e} of its element's float32 limit"
                  f"{' (+ 1 bf16 ulp)' if name == 'dgrad' else ''}", flush=True)
            check(share <= 1.0, f"16 {label}: K9's {name} disagrees with its plain version")
        # what the limit makes of terms rounded to bf16: a record, and a check
        # that it sees them
        dw, db = wgrad_entry(feat, cot.bfloat16().float())
        row["bf16_terms"] = {
            "wgrad": share_of_limit(dw, want[2], limits[2]),
            "bias": share_of_limit(db, want[3], limits[3]),
            "fwd": share_of_limit(fwd_entry(feat, w.bfloat16().float(), b), want[0], limits[0])}
        del dw, db
        print(f"#   16 {label}: bf16-rounded cotangent (wgrad, bias) and weights (fwd), the "
              f"largest error as a share of the limit: {row['bf16_terms']}", flush=True)
        check(min(row["bf16_terms"].values()) > 1.0,
              f"16 {label}: terms rounded to bf16 pass the float32 limit")
        lib = grads(library)
        row["vs_library"] = {n: float((k.float() - q.float()).abs().max())
                             for n, k, q in zip(("fwd", "dgrad", "wgrad", "bias"), got, lib)}
        print(f"#   16 {label}: against the library conv (a record): {row['vs_library']}",
              flush=True)
        del got, want, limits, lib
        again = [k9_grads() for _ in range(2)]
        check(all(torch.equal(x, y) for x, y in zip(*again)),
              f"16 {label}: two backward runs gave different bits")
        del again

        V, fb = math.prod(shape), feat.element_size()
        ops = 2 * V * 27 * C * 3
        bounds = {"fwd": bound(V * C * fb + V * 3 * 4, ops, FP32_FLOPS),
                  "dgrad": bound(V * 3 * 4 + V * C * fb, ops, FP32_FLOPS),
                  "wgrad": bound(V * C * fb + V * 3 * 4, ops, FP32_FLOPS)}
        n = 3 if rehearsal else 10
        plain_kw = {"n": 1, "reps": 2, "warmup": 1}
        row["fwd"] = measure(
            timer, f"flow_head forward {label}", bounds["fwd"],
            inference(lambda: fwd_entry(feat, w, b)),
            inference(lambda: fh.flow_head_plain(feat, w, b)),
            inference(lambda: library(feat, w, b)), n=n, plain_kw=plain_kw)
        row["dgrad"] = measure(
            timer, f"flow_head input gradient {label}", bounds["dgrad"],
            inference(lambda: dgrad_entry(cot, w, feat.dtype)),
            inference(lambda: fh.flow_head_dgrad_plain(cot, w, feat.dtype)),
            backward_call(lambda fe: library(fe, w, b), [feat], cot), n=n, plain_kw=plain_kw)
        row["wgrad"] = measure(
            timer, f"flow_head weight gradient {label}", bounds["wgrad"],
            inference(lambda: wgrad_entry(feat, cot)),
            inference(lambda: fh.flow_head_wgrad_plain(feat, cot)),
            backward_call(lambda we, be: library(feat, we, be), [w, b], cot), n=n,
            plain_kw=plain_kw)
        for name in ("fwd", "dgrad", "wgrad"):
            r = row[name]
            r.pop("device_rows", None)
            dev_ms, lib_ms = r["device_ms"], r["library_ms"]
            dev_s = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            share = "not measured" if dev_ms is None else f"{100 * r['bound'][0] / dev_ms:.1f}%"
            lib_s = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"#   16 {label} {name}: {r['ms']:.4f} ms, device {dev_s} in "
                  f"{r['device_ops']} operations, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; "
                  f"device time at {share} of it), plain {r['plain_ms']:.3f} ms, library {lib_s}",
                  flush=True)
        numbers["shapes"][label] = row
        del feat, w, b, cot

    # the launches of one flagship forward and of one loss-and-backward
    shape = (32, 32, 48) if rehearsal else (160, 160, 192)
    model = VxmDense(VxmConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in FLAGSHIP.items()}), device=dev)
    mov = torch.rand((1, *shape, 1), generator=gen, device=dev)
    fx = torch.rand((1, *shape, 1), generator=gen, device=dev)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        model(mov, fx)
    if cuda:
        torch.cuda.synchronize()
    counts["16_forward"] = kernels.launch_counts()
    fwd_entries = kernels.entry_launch_counts()
    kernels.reset_launch_counts()
    out = model(mov, fx, with_moved=False)
    out["warp"].square().mean().backward()
    if cuda:
        torch.cuda.synchronize()
    counts["16_train"] = kernels.launch_counts()
    train_entries = kernels.entry_launch_counts()
    print(f"#   16: K9 launches of one flagship forward {counts['16_forward']['flow_head']} "
          f"({ {k: v for k, v in fwd_entries.items() if k.startswith('flow_head')} }); of one "
          f"loss-and-backward {counts['16_train']['flow_head']} "
          f"({ {k: v for k, v in train_entries.items() if k.startswith('flow_head')} })",
          flush=True)
    want = model.kernel_launches()
    if not rehearsal:
        check({**counts["16_forward"], **fwd_entries} == want,
              f"16: a flagship forward launched {fwd_entries}, want {want}")
        check(all(train_entries.get(e) == 1 for e in FLOW_HEAD_ENTRIES)
              and counts["16_train"]["flow_head"] == 4,
              f"16: a loss-and-backward launched K9 {train_entries}, want each entry once")
    del model, out, mov, fx
    flag = numbers["shapes"]["flagship"]
    timing["flow_head"] = dict(flag["fwd"], shapes={
        label: {name: {k: r[name][k] for k in ("ms", "device_ms", "device_ops", "plain_ms",
                                               "library_ms", "library_device_ms")}
                | {"bound_ms": r[name]["bound"][0], "bound_by": r[name]["bound"][1],
                   "max_abs_err": r["err"][name]}
                for name in ("fwd", "dgrad", "wgrad")} | {"shape": r["shape"]}
        for label, r in numbers["shapes"].items()})
    results["flow_head"]["max_abs_err"] = flag["err"]["fwd"]
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 16: {numbers['total_s']:.1f} s of its budget of {PHASE16_BUDGET_S} s",
          flush=True)
    check(rehearsal or numbers["total_s"] <= PHASE16_BUDGET_S,
          f"phase 16 took {numbers['total_s']:.1f} s, over its budget of {PHASE16_BUDGET_S} s")
    return counts, numbers


PHASE17_BUDGET_S = 60  # of the script's 1200 s
# the decoder's three (x, skip) levels of a 160x160x192 forward, nb_upsample_skips 1
UP_CAT_LEVELS = (((1, 10, 10, 12), (1, 20, 20, 24)), ((1, 20, 20, 24), (1, 40, 40, 48)),
                 ((1, 40, 40, 48), (1, 80, 80, 96)))


def up_cat_phase(dev, timer, rehearsal, results, timing):
    """Phase 17: K10, the decoder's nearest 2x upsample and skip concatenation
    (``ops/up_cat.py``), at the three levels of a flagship and of a w256
    forward (:data:`UP_CAT_LEVELS`, bf16, 64 and 256 channels): each launch
    equal to its plain version bit for bit; then a pair's three launches
    timed (ms; device ms and operations, the sum of each level's) beside
    their bound (x and skip read once, the concatenation written once, at
    3.35 TB/s), the plain version (``impl="plain"``) and the PyTorch
    composition K10 replaced, ``F.interpolate`` + ``torch.cat`` (the
    yardstick; the plain version is the same composition behind the
    wrapper). Returns its numbers."""
    import torch
    import torch.nn.functional as F

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.ops.up_cat import upsample_cat, upsample_cat_plain

    t_phase = time.perf_counter()
    numbers = {"shapes": {}}
    print("# phase 17: K10, the decoder's upsample and concatenation", flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)

    def inference(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    def library(x, skip):  # what the U-Net ran before K10
        up = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=2, mode="nearest")
        return torch.cat([up.permute(0, 2, 3, 4, 1), skip], -1)

    for label, C in (("flagship", 64), ("w256", 256)):
        levels = []
        for low, high in UP_CAT_LEVELS:
            if rehearsal:
                low = (1, *(s // 5 for s in low[1:]))
                high = (1, *(2 * s for s in low[1:]))
            levels.append((torch.randn((*low, C), generator=gen, device=dev).bfloat16(),
                           torch.randn((*high, C), generator=gen, device=dev).bfloat16()))
        row = {"levels": [], "exact": []}
        nbytes = 0
        for x, skip in levels:
            kernels.reset_launch_counts()
            with torch.inference_mode():
                got = upsample_cat(x, skip)
                want = upsample_cat_plain(x, skip)
            launched = kernels.UP_CAT.launches
            exact = bool(torch.equal(got, want))
            shape = [list(x.shape), list(skip.shape)]
            print(f"#   17 {label} x {shape[0]} skip {shape[1]}: equal to the plain version "
                  f"bit for bit: {exact}; launches {launched}", flush=True)
            check(exact, f"17 {label} {shape}: K10 disagrees with its plain version")
            check(rehearsal or launched == 1, f"17 {label} {shape}: launched K10 {launched} times")
            nbytes += x.nbytes + skip.nbytes + got.nbytes
            lvl = {"shape": shape, "bytes": x.nbytes + skip.nbytes + got.nbytes}
            lvl["device_ms"], lvl["device_ops"], _ = device_time(
                inference(lambda: upsample_cat(x, skip)))
            lvl["library_device_ms"], lvl["library_device_ops"], _ = device_time(
                inference(lambda: library(x, skip)))
            row["levels"].append(lvl)
            row["exact"].append(exact)
            del got, want
        # a pair's device time is the sum of its levels', each profiled alone: a
        # window of several short kernels a call can lose device records (device_time)
        n = 3 if rehearsal else 20
        row.update({
            "ms": timer(inference(lambda: [upsample_cat(x, s) for x, s in levels]), n=n),
            "plain_ms": timer(inference(lambda: [upsample_cat(x, s, impl="plain")
                                                 for x, s in levels]), n=n, reps=3),
            "library_ms": timer(inference(lambda: [library(x, s) for x, s in levels]), n=n),
            "bound": bound(nbytes, 0, BF16_TENSOR_FLOPS), "bytes": nbytes})
        for key in ("device_ms", "device_ops", "library_device_ms", "library_device_ops"):
            vals = [lvl[key] for lvl in row["levels"]]
            row[key] = None if None in vals else sum(vals)
        dev_ms = row["device_ms"]
        share = "not measured" if dev_ms is None else f"{100 * row['bound'][0] / dev_ms:.1f}%"
        print(f"#   17 {label} a pair's three launches: {row['ms']:.4f} ms, device "
              f"{ms_or_none(dev_ms)} in {row['device_ops']} operations (levels "
              f"{[ms_or_none(v['device_ms']) for v in row['levels']]}), bound "
              f"{row['bound'][0]:.4f} ms ({nbytes / 1e6:.1f} MB; device time at {share} of it), "
              f"plain {row['plain_ms']:.4f} ms, yardstick {ms_or_none(row['library_ms'])} "
              f"({ms_or_none(row['library_device_ms'])} device)", flush=True)
        numbers["shapes"][label] = row
        del levels
    flag = numbers["shapes"]["flagship"]
    timing["up_cat"] = dict(flag, shapes={
        label: {k: r[k] for k in ("ms", "device_ms", "device_ops", "plain_ms", "library_ms",
                                  "library_device_ms", "levels", "bytes")}
        | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
        for label, r in numbers["shapes"].items()})
    results["up_cat"]["max_abs_err"] = 0.0  # every launch above was equal, bit for bit
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 17: {numbers['total_s']:.1f} s of its budget of {PHASE17_BUDGET_S} s",
          flush=True)
    check(rehearsal or numbers["total_s"] <= PHASE17_BUDGET_S,
          f"phase 17 took {numbers['total_s']:.1f} s, over its budget of {PHASE17_BUDGET_S} s")
    return numbers


PHASE18_BUDGET_S = 90  # of the script's 1200 s
# the output levels of a 160x160x192 forward's nine library convs, nb_upsample_skips 1:
# enc_1, dec_3, final_0, final_1 at half resolution, two convs at each coarser level
# but the coarsest (dec_0)
BIAS_LRELU_LEVELS = (((1, 80, 80, 96), 4), ((1, 40, 40, 48), 2), ((1, 20, 20, 24), 2),
                     ((1, 10, 10, 12), 1))


def bias_lrelu_phase(dev, timer, rehearsal, results, timing):
    """Phase 18: K11, the library convs' bias and LeakyReLU in place
    (``ops/bias_lrelu.py``), at each library conv's output shape of a flagship
    and of a w256 forward (:data:`BIAS_LRELU_LEVELS`, 64 and 256 channels,
    channels-last), in bf16 and in float32: equal bit for bit to its plain
    version and to the library's broadcast ``add_`` of the bias cast to the
    compute type and ``F.leaky_relu``, which the U-Net ran before K11. Then,
    in bf16, each level's launch timed (ms; device ms and operations) beside
    its bound (the output read once and written once at 3.35 TB/s), the plain
    version (``impl="plain"``) and the library's composition (the yardstick),
    and the nine launches of a pair summed from the levels. Returns its
    numbers."""
    import torch
    import torch.nn.functional as F

    from multimodal_registration_torch import kernels
    from multimodal_registration_torch.ops.bias_lrelu import bias_lrelu_, bias_lrelu_plain

    t_phase = time.perf_counter()
    numbers = {"shapes": {}}
    print("# phase 18: K11, the library convs' bias and LeakyReLU in place", flush=True)
    gen = torch.Generator(device=dev).manual_seed(18)

    def output(level, C, dtype):  # a conv's output as cuDNN returns it, channels-last
        return torch.randn((*level, C), generator=gen, device=dev).to(dtype).permute(
            0, 4, 1, 2, 3)

    def library(y, b):  # what the U-Net ran before K11
        return F.leaky_relu(y.add_(b.to(y.dtype).view(1, -1, 1, 1, 1)), 0.2)

    def inference(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    levels = [((1, *(max(2, s // 10) for s in level[1:])), n) if rehearsal else (level, n)
              for level, n in BIAS_LRELU_LEVELS]
    exact = []
    for label, C in (("flagship", 64), ("w256", 256)):
        b = 0.5 * torch.randn(C, generator=gen, device=dev)
        row = {"levels": []}
        for dtype in (torch.bfloat16, torch.float32):
            for level, _ in levels:
                y = output(level, C, dtype)
                want = library(y.clone(), b)
                with torch.inference_mode():
                    kernels.reset_launch_counts()
                    got = bias_lrelu_(y.clone(), b, 0.2)
                    launched = kernels.BIAS_LRELU.launches
                    plain = bias_lrelu_plain(y.clone(), b, 0.2)
                same = bool(torch.equal(got, want) and torch.equal(got, plain))
                exact.append(same)
                print(f"#   18 {label} {str(dtype)[6:]} {list(y.shape)}: equal to the library's "
                      f"add + LeakyReLU and to the plain version bit for bit: {same}; "
                      f"launches {launched}", flush=True)
                check(same, f"18 {label} {list(y.shape)} {dtype}: K11 disagrees")
                check(rehearsal or launched == 1,
                      f"18 {label} {list(y.shape)}: launched K11 {launched} times")
                del y, want, got, plain
        n = 3 if rehearsal else 20
        for level, count in levels:
            y = output(level, C, torch.bfloat16)
            nbytes = 2 * y.nbytes
            lvl = {"shape": list(y.shape), "convs": count, "bytes": nbytes,
                   "bound": bound(nbytes, 0, BF16_TENSOR_FLOPS)}
            lvl["ms"] = timer(inference(lambda: bias_lrelu_(y, b, 0.2)), n=n)
            lvl["plain_ms"] = timer(inference(lambda: bias_lrelu_(y, b, 0.2, impl="plain")),
                                    n=max(1, n // 10), reps=3)
            lvl["library_ms"] = timer(inference(lambda: library(y, b)), n=n)
            lvl["device_ms"], lvl["device_ops"], _ = device_time(
                inference(lambda: bias_lrelu_(y, b, 0.2)))
            lvl["library_device_ms"], lvl["library_device_ops"], _ = device_time(
                inference(lambda: library(y, b)))
            dev_ms = lvl["device_ms"]
            share = ("not measured" if dev_ms is None
                     else f"{100 * lvl['bound'][0] / dev_ms:.1f}%")
            print(f"#   18 {label} bf16 {lvl['shape']}: {lvl['ms']:.4f} ms, device "
                  f"{ms_or_none(dev_ms)} in {lvl['device_ops']} operations, bound "
                  f"{lvl['bound'][0]:.4f} ms ({nbytes / 1e6:.1f} MB; device time at {share} of "
                  f"it), plain {lvl['plain_ms']:.4f} ms, yardstick {lvl['library_ms']:.4f} ms "
                  f"({ms_or_none(lvl['library_device_ms'])} device in "
                  f"{lvl['library_device_ops']} operations)", flush=True)
            row["levels"].append(lvl)
            del y
        top = row["levels"][0]  # 80x80x96: the kernels line's row
        row.update({k: top[k] for k in ("ms", "plain_ms", "library_ms", "device_ms",
                                        "device_ops", "library_device_ms", "bound")})
        row["shape"] = top["shape"]
        for key in ("device_ms", "library_device_ms", "ms", "library_ms"):
            vals = [lvl[key] for lvl in row["levels"]]
            row[f"pair_{key}"] = (None if None in vals else
                                  sum(v * lvl["convs"] for v, lvl in zip(vals, row["levels"])))
        row["pair_bound_ms"] = sum(lvl["bound"][0] * lvl["convs"] for lvl in row["levels"])
        print(f"#   18 {label} a pair's nine launches: device {ms_or_none(row['pair_device_ms'])}, "
              f"bound {row['pair_bound_ms']:.4f} ms, yardstick "
              f"{ms_or_none(row['pair_library_device_ms'])} device", flush=True)
        numbers["shapes"][label] = row
    top = numbers["shapes"]["w256"]
    timing["bias_lrelu"] = dict(top, shapes={
        label: {k: r[k] for k in ("shape", "ms", "device_ms", "device_ops", "plain_ms",
                                  "library_ms", "library_device_ms", "pair_device_ms",
                                  "pair_library_device_ms", "pair_ms", "pair_library_ms",
                                  "pair_bound_ms")}
        | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1],
           "levels": [{k: v for k, v in lvl.items() if k != "bound"} | {"bound_ms": lvl["bound"][0]}
                      for lvl in r["levels"]]}
        for label, r in numbers["shapes"].items()})
    results["bias_lrelu"]["max_abs_err"] = 0.0  # every launch above was equal, bit for bit
    numbers["exact"] = all(exact)
    numbers["total_s"] = time.perf_counter() - t_phase
    print(f"#   phase 18: {numbers['total_s']:.1f} s of its budget of {PHASE18_BUDGET_S} s",
          flush=True)
    check(rehearsal or numbers["total_s"] <= PHASE18_BUDGET_S,
          f"phase 18 took {numbers['total_s']:.1f} s, over its budget of {PHASE18_BUDGET_S} s")
    return numbers


def ms_or_none(v):
    return "not measured" if v is None else f"{v:.4f} ms"


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
    for path in (CKPT, CKPT_MODEL1, W256_CKPT, W256_SIDECAR):
        check(os.path.exists(path), f"{path} missing")

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
    # K1: bf16 on the tensor cores at the flagship shape, at a ragged shape
    # with batch 2 that no tile divides, and at the published width 256; float32
    # on the float32 units. bf16: 1 bf16 ulp of max|out| (one float32 sum,
    # summed in another order, rounded once); float32: 1e-5
    # F12: the w256 first level at 192^3 with batch 2 (bench_torch.py --batch 2
    # --arch infer256), which the old guard refused; its plain version's float32
    # activation is about 14.5 GB
    f12 = (2, 16, 16, 16, 2) if rehearsal else (2, 192, 192, 192, 2)
    errs = []
    for label, xs, cout, dt in (
        ("flagship", (1, *shape, 2), 64, torch.bfloat16),
        ("ragged, batch 2", (2, 18, 12, 36, 2), 12, torch.bfloat16),
        ("Cout 256", (1, 20, 24, 40, 2), 256, torch.bfloat16),
        ("float32", (2, 18, 12, 36, 2), 64, torch.float32),
        ("w256 at 192^3, batch 2 (F12)", f12, 256, torch.bfloat16),
    ):
        x1 = torch.as_tensor(rng.normal(size=xs).astype(np.float32), device=dev).to(dt)
        w1 = torch.as_tensor(rng.normal(scale=0.2, size=(cout, 2, 3, 3, 3)).astype(np.float32),
                             device=dev)
        b1 = torch.as_tensor(rng.normal(scale=0.1, size=(cout,)).astype(np.float32), device=dev)
        p1 = conv3_lrelu_pool(x1, w1, b1, impl="plain")
        tol = bf16_ulp(float(p1.float().abs().max())) if dt == torch.bfloat16 else 1e-5
        errs.append(compare(f"K1 conv3_lrelu_pool {label} {xs} -> {cout} "
                            f"({'tol 1 bf16 ulp of max|out|' if dt == torch.bfloat16 else 'f32'})",
                            conv3_lrelu_pool(x1, w1, b1), p1, tol))
    results["conv3_lrelu_pool"]["max_abs_err"] = errs[0]
    del x1, p1
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the F12 check's plain activation

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

    # K8 at a ragged shape. Its plain version runs on the CPU (its float64
    # products on the card would leave cuBLAS's workspace allocated) and its
    # inputs are inference tensors (K8 keeps no prepared weights for them),
    # so that this check holds nothing on the card that the flagship
    # forward's peak memory would count
    label, cin, cout, bg = K8_RAGGED
    with torch.inference_mode():
        k8_args = k8_inputs(dev, bg, cin, cout, 7)
    results["conv3_int8"]["max_abs_err"] = k8_check(label, *k8_args, plain_device="cpu")
    del k8_args

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
        per_fwd = {**kernels.launch_counts(), **kernels.entry_launch_counts()}
        out_p = model(mov_t, fx_t, impl="plain")
    print(f"#   launches per forward: {per_fwd}")
    serving = model.kernel_launches()
    if not rehearsal:
        check(per_fwd == serving, f"forward launched {per_fwd}, want {serving}")
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
    # K1's weights are prepared once per parameter version: a call is one launch
    check(rehearsal or timing["conv3_lrelu_pool"]["device_ops"] == 1,
          f"a conv3_lrelu_pool call enqueues {timing['conv3_lrelu_pool']['device_ops']} device "
          "operations, not 1: the prepared weights are not cached")

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
    if not rehearsal:
        check(all(launches[k] >= 1 for k in launches if serving[k]),
              f"a kernel of the serving path was not launched by register(): {launches}")

    # ---- 5. training -----------------------------------------------------------
    print("# phase 5: training (run_training, flagship widths)", flush=True)
    with tempfile.TemporaryDirectory() as td:
        train_launches, train_numbers = training_phase(dev, shape, timer, rehearsal, td)
    training = [k for k, v in train_numbers["step_launches"].items() if v]
    if not rehearsal:
        check(all(train_launches[k] >= 1 for k in training)
              and all(train_numbers["entries"].get(e, 0) >= 1 for e in DICE_ENTRIES.values()),
              f"a kernel of the training path was not launched by run_training(): "
              f"{train_launches}, {train_numbers['entries']}")
        # K1 serves the validation steps (no gradient is asked there): one
        # launch each; K3 never runs, the loss does not read `moved`
        check(train_launches["conv3_lrelu_pool"] == 2 and train_launches["warp_up2x"] == 0,
              f"inference-only kernels in run_training, want K1 x2 (validation), K3 x0: "
              f"{train_launches}")

    # ---- 6. register() on real-scan layouts, the cascade, evaluation --------
    with tempfile.TemporaryDirectory() as td:
        scan_launches, scan_numbers = real_scan_phases(dev, timer, rehearsal, cfg, params, fx_np,
                                                       mov_np, td)
    print(f"#   phase 6 numbers: {json.dumps(scan_numbers)}")

    # ---- 7. the published widths, bf16 and int8 --------------------------------
    clear_scratch()
    with tempfile.TemporaryDirectory() as td:
        k8_rows, w256_launches, w256_numbers = published_widths_phase(dev, timer, rehearsal,
                                                                      fx_np, mov_np, td)
    print(f"#   phase 7 numbers: {json.dumps(w256_numbers)}")

    # ---- 8. the BIDS batch pipeline ---------------------------------------------
    with tempfile.TemporaryDirectory() as td:
        pipe_launches, pipe_numbers = pipeline_phase(dev, rehearsal, td)
    print(f"#   phase 8 numbers: {json.dumps(pipe_numbers)}")

    # ---- 9. the port's training learns at full width ----------------------------
    clear_scratch()
    with tempfile.TemporaryDirectory() as td:
        learn_launches, learn_numbers = learning_phase(dev, rehearsal, td)
    # K8's row: its widest call, dec_3 (512 -> 256 at 80x80x96); every shape in "shapes"
    timing["conv3_int8"] = dict(next(r for r in k8_rows if r["label"] == "dec_3"))
    timing["conv3_int8"]["shapes"] = [
        {k: r[k] for k in ("label", "shape", "cin", "cout", "ops", "ms", "device_ms",
                           "conv_device_ms", "quantize_device_ms", "quantize_bound_ms",
                           "device_ops", "plain_ms", "library_ms", "library_device_ms")}
        | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]} for r in k8_rows]

    # ---- 10. multi-GPU ----------------------------------------------------------
    clear_scratch()
    with tempfile.TemporaryDirectory() as td:
        multi_launches, multi_numbers = multi_gpu_phase(dev, timer, rehearsal, fx_np, mov_np, td)
    print(f"#   phase 10 numbers: {json.dumps(multi_numbers)}")

    # ---- 11. the bench at 192^3, int8 under the quality gate --------------------
    clear_scratch()
    bench_launches, bench_numbers = bench_phase(dev, rehearsal)
    print(f"#   phase 11 numbers: {json.dumps(bench_numbers)}")

    # ---- 12. pipeline quality on held-out subjects --------------------------------
    clear_scratch()
    with tempfile.TemporaryDirectory() as td:
        quality_launches, quality_numbers = quality_phase(dev, rehearsal, td)
    print(f"#   phase 12 numbers: {json.dumps(quality_numbers)}")

    # ---- 13. the training step's and the pipeline's measurement tools ----------------
    clear_scratch()
    tools_launches, tools_numbers, k4_w256 = measurement_phase(dev, shape, timer, rehearsal)
    timing["max_pool_2x_bwd"]["w256"] = k4_w256
    print(f"#   phase 13 numbers: {json.dumps(tools_numbers)}")

    # ---- 14. the studies ------------------------------------------------------------------
    clear_scratch()
    with tempfile.TemporaryDirectory() as td:
        study_launches, study_numbers = studies_phase(dev, rehearsal, td)
    print(f"#   phase 14 numbers: {json.dumps(study_numbers)}")

    # ---- 15. the last probes and entry() ----------------------------------------------
    clear_scratch()
    probe_launches, probe_numbers = probes_phase(dev, rehearsal, (mov_t, fx_t, out_k))
    print(f"#   phase 15 numbers: {json.dumps(probe_numbers)}")

    # ---- 16. the flow head's conv (K9) at its callers' shapes --------------------
    clear_scratch()
    head_launches, head_numbers = flow_head_phase(dev, timer, rehearsal, results, timing)
    print(f"#   phase 16 numbers: {json.dumps(head_numbers)}")

    # ---- 17. the decoder's upsample and concatenation (K10) ----------------------
    clear_scratch()
    up_numbers = up_cat_phase(dev, timer, rehearsal, results, timing)

    # ---- 18. the library convs' bias and LeakyReLU (K11) --------------------------
    clear_scratch()
    bias_numbers = bias_lrelu_phase(dev, timer, rehearsal, results, timing)

    # ---- 19. report ----------------------------------------------------------
    # launches: of the main path that runs the kernel, counted from zero just
    # before it: register() for a flagship forward's kernels (K1-K3, K9-K11),
    # run_training() for K4-K7, register() with the published config in int8 (7d) for K8
    report = []
    for k in kernels.KERNELS:
        row = timing[k.name]
        main_path = (w256_launches["7d"] if k.name == "conv3_int8" else
                     launches if serving[k.name] else train_launches)
        report.append({
            "name": k.name, "route": "cuda",
            "source": f"multimodal_registration_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": main_path[k.name],
            "launches_register": launches[k.name],
            "launches_run_training": train_launches[k.name],
            **{f"launches_{phase}": n[k.name] for phase, n in scan_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in w256_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in pipe_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in learn_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in multi_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in bench_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in quality_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in tools_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in study_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in probe_launches.items()},
            **{f"launches_{phase}": n[k.name] for phase, n in head_launches.items()},
            "max_abs_err": results[k.name]["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "device_ops": row["device_ops"], "library_device_ms": row["library_device_ms"],
        })
        if "bound_needed" in row:  # K7: bound_ms counts sectors moved, this one entries needed
            report[-1].update({"bound_needed_ms": row["bound_needed"][0],
                               "bound_needed_by": row["bound_needed"][1]})
        if "shapes" in row:  # K8: every int8 conv shape of the w256 forward; K9-K11: 16-18's
            report[-1]["shapes"] = row["shapes"]
        if "w256" in row:  # K4: the pools of the w256 training step, 256 channels (13a)
            report[-1]["w256"] = row["w256"]
        if "fused" in row:  # K2 and K5: the fused squaring step, timed on its own
            fused = row["fused"]
            report[-1].update({
                "fused_max_abs_err": results[k.name]["fused_max_abs_err"],
                "fused_ms": fused["ms"], "fused_device_ms": fused["device_ms"],
                "fused_device_ops": fused["device_ops"], "fused_plain_ms": fused["plain_ms"],
                "fused_bound_ms": fused["bound"][0], "fused_bound_by": fused["bound"][1],
            })
    # the Dice entries of K6 and K7, each a row of its own: launches of the
    # training path (run_training), counted by entry
    for name, symbol in DICE_ENTRIES.items():
        row = timing[name]
        owner = kernels.WARP_LABELS if name.endswith("fwd") else kernels.WARP_LABELS_BWD
        report.append({
            "name": name, "route": "cuda",
            "source": f"multimodal_registration_torch/csrc/{owner.source}",
            "replaces": owner.replaces, "entry_of": owner.name,
            "launches": train_numbers["entries"].get(symbol, 0),
            "launches_14": study_numbers["entries"].get(symbol, 0),
            "launches_15": probe_numbers["entries"].get(symbol, 0),
            "max_abs_err": results[name]["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "device_ops": row["device_ops"], "library_device_ms": row["library_device_ms"],
        })
        if "bound_needed" in row:
            report[-1].update({"bound_needed_ms": row["bound_needed"][0],
                               "bound_needed_by": row["bound_needed"][1]})
        if "paths" in row:  # the Dice loss's forward + backward, fused against dense
            report[-1]["loss_paths"] = row["paths"]
    print(json.dumps({"kernels": report}))
    print(f"# forward_ms {fwd_ms:.4f} pairs_per_s {1000 / fwd_ms:.4f} peak_mib {peak:.1f} "
          f"train_s_per_step {train_numbers['step_s']:.4f} "
          f"train_peak_mib {train_numbers['train_peak_mib']:.1f} "
          f"phase6_s {scan_numbers['total_s']:.1f} "
          f"w256_bf16_ms {w256_numbers['7b']['ms']:.4f} w256_int8_ms {w256_numbers['7c']['ms']:.4f} "
          f"phase7_s {w256_numbers['total_s']:.1f} "
          f"pipeline_s_per_subject {pipe_numbers['8a']['s_per_subject']:.3f} "
          f"sync_s_per_subject {pipe_numbers['8b']['s_per_subject']:.3f} "
          f"phase8_s {pipe_numbers['total_s']:.1f} "
          f"learn_s_per_step_p50 {learn_numbers['9a']['step_seconds']['p50']:.4f} "
          f"learned {str(learn_numbers['9a']['learned']).lower()} "
          f"phase9_s {learn_numbers['total_s']:.1f} "
          f"sharded_forward_ms {multi_numbers['10a']['sharded_ms']:.4f} "
          f"dp_step_s {multi_numbers['10e']['step_s']:.4f} "
          f"dp_step_1dev_s {multi_numbers['10e']['step_1dev_s']:.4f} "
          f"phase10_s {multi_numbers['total_s']:.1f} "
          + " ".join(f"bench_{metric} {line['value']}" for (_, _, metric), line
                     in zip(BENCH_SPECS, bench_numbers['11a']['lines']))
          + f" int8_dice_gap {bench_numbers['11b']['gap']['dice']:.4f} "
          f"int8_nmi_gap {bench_numbers['11b']['gap']['nmi']:.4f} "
          f"phase11_s {bench_numbers['total_s']:.1f} "
          + " ".join(f"sc_dice_after_{arm} {statistics.mean(a for _, a in s['dice_before_after']):.4f}"
                     for arm, s in quality_numbers['12a']['summary'].items()
                     if s['dice_before_after'])
          + f" two_step_minus_single {quality_numbers['12b']['summary']['two_step_minus_single']} "
          f"phase12_s {quality_numbers['total_s']:.1f} "
          + " ".join(f"train_bench_{label.replace(' ', '_')}_s_per_step {r['sec_per_step']:.6f}"
                     for label, r in tools_numbers['13a'].items())
          + " " + " ".join(f"pipeline_{name}_subjects_per_min {c['subjects_per_min']:.4f}"
                           for name, c in tools_numbers['13d']['configs'].items())
          + f" phase13_s {tools_numbers['total_s']:.1f} "
          + " ".join(f"ablate_{k} {v}" for k, v in study_numbers['14a']['rows'].items()
                     if k != "shape")
          + f" unet_full_bwd_ms {study_numbers['14b']['rows']['unet_full_bwd_ms']} "
          f"learn_ref_dice_step0 {study_numbers['14c']['record']['trajectory'][0]['dice']} "
          f"learn_ref_dice_last {study_numbers['14c']['record']['trajectory'][-1]['dice']} "
          f"fold_warp1_sigma0 {study_numbers['14f']['sweep']['rows'][0]['fold_warp1_only']} "
          f"phase14_s {study_numbers['total_s']:.1f} "
          + " ".join(f"svf4_dice_arm{r} {p[-1]['dice']}"
                     for r, p in probe_numbers['15a']['record']['arms'].items())
          + " " + " ".join(f"conv_{r['case']}_tflops {r['flops'] / r['seconds'] / 1e12:.2f}"
                           for r in probe_numbers['15b']['rows'])
          + f" interleave_speedup {probe_numbers['15c']['results']['speedup_interleave_vs_2x_single']} "
          f"entry_fn_ms {probe_numbers['15d']['ms']:.4f} "
          f"phase15_s {probe_numbers['total_s']:.1f} "
          + " ".join(f"flow_head_{label}_{name}_device_ms {r[name]['device_ms']}"
                     for label, r in head_numbers["shapes"].items()
                     for name in ("fwd", "dgrad", "wgrad"))
          + f" phase16_s {head_numbers['total_s']:.1f} "
          + " ".join(f"up_cat_{label}_device_ms {r['device_ms']}"
                     for label, r in up_numbers["shapes"].items())
          + f" phase17_s {up_numbers['total_s']:.1f} "
          + " ".join(f"bias_lrelu_{label}_device_ms {r['device_ms']} "
                     f"bias_lrelu_{label}_pair_device_ms {r['pair_device_ms']}"
                     for label, r in bias_numbers["shapes"].items())
          + f" phase18_s {bias_numbers['total_s']:.1f} total_s {time.time() - t_start:.1f}")
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
