#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py               # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu  # rehearsal: tiny shapes, plain versions

Phases (any failure exits non-zero):
  1. build the hand-written kernels (csrc/*.cu, one nvcc each, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes of the flagship forward;
  3. the flagship forward (VxmDense enc [64]x4 / dec [64]x6, int_steps 5,
     svf_res = int_res = 2, bf16) on the in-repo checkpoint at
     (1, 160, 160, 192, 1): kernel path against the plain path, launch
     counts per forward, ms per forward, pairs/s, peak memory, and each
     kernel's time beside its bound, its plain version and a PyTorch
     yardstick that the port never calls;
  4. ``register()`` end to end on a synthetic 1 mm NIfTI pair of that size;
  5. the card's name and power limit.
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


def profile_forward(model, mov, fx, n=3, top=10):
    """Where a forward's device time goes: ``torch.profiler`` over ``n``
    forwards, device time by operator per forward, and the device's busy
    share of the wall time (kernel time summed / wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(mov, fx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(mov, fx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side entries only (kernels, copies): operator entries on the
    # host would count their kernels' time a second time
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / n
    if not events:
        print("#   profile: the profiler recorded no device time (not measured)")
        return
    print(f"#   profile ({n} forwards): device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"per forward, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"#     {dev_us(e) / 1e3 / n:9.4f} ms  x{e.count // n:<3d} {e.key[:90]}")


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            sample, warp_batch, warp_up2x_batch)
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

    def compare(name, got, ref, tol, exact=False):
        err = float((got.float() - ref.float()).abs().max())
        ok = err == 0.0 if exact else err <= tol
        print(f"#   {name}: max_abs_err {err:.3e} (tolerance {'exact' if exact else f'{tol:.3e}'})"
              f" {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"{name} disagrees with its plain version")
        return err

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

    mov_img = torch.as_tensor(rng.random((1, *shape, 1)).astype(np.float32), device=dev)
    fh = smooth_field(half, 3.0, 2, dev)
    results["warp_up2x"]["max_abs_err"] = compare(
        "K3 warp_up2x f32", warp_up2x_batch(mov_img, fh),
        warp_up2x_batch(mov_img, fh, impl="plain"), 1e-5)

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
        check(per_fwd == {"conv3_lrelu_pool": 1, "warp_trilinear": 5, "warp_up2x": 1},
              f"forward launched {per_fwd}, want K1 x1, K2 x5, K3 x1")
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
        profile_forward(model, mov_t, fx_t)

    # each kernel at the path's shapes, beside its bound, plain and yardstick
    import torch.nn.functional as F

    xk = torch.cat([mov_t, fx_t], -1).bfloat16().contiguous()
    wk = model.unet.enc_0.conv.weight.detach()
    bk = model.unet.enc_0.conv.bias.detach()
    phi_k = out_k["warp"].contiguous()
    with torch.inference_mode():
        t_k1 = timer(lambda: conv3_lrelu_pool(xk, wk, bk))
        t_k1p = timer(lambda: conv3_lrelu_pool(xk, wk, bk, impl="plain"), n=3)
        xc = xk.permute(0, 4, 1, 2, 3)
        wkb, bkb = wk.bfloat16(), bk.bfloat16()
        t_k1l = timer(lambda: F.max_pool3d(F.leaky_relu(F.conv3d(xc, wkb, bkb, padding=1), 0.2), 2))
        pb = phi_k.bfloat16()
        t_k2 = timer(lambda: warp_batch(pb, phi_k), n=20)
        t_k2p = timer(lambda: warp_batch(pb, phi_k, impl="plain"), n=5)
        # grid_sample's grid is (z, y, x)-ordered and normalised to [-1, 1]
        hgrid = torch.stack(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                                             for s in half], indexing="ij"), -1)
        dims = torch.tensor(half, dtype=torch.float32, device=dev) - 1
        gnorm = ((hgrid + phi_k[0]) / dims * 2 - 1).flip(-1)[None].contiguous()
        vin = phi_k.permute(0, 4, 1, 2, 3).contiguous()
        t_k2l = timer(lambda: F.grid_sample(vin, gnorm, mode="bilinear", padding_mode="border",
                                            align_corners=True), n=20)
        t_k3 = timer(lambda: warp_up2x_batch(mov_t, phi_k), n=20)
        t_k3p = timer(lambda: warp_up2x_batch(mov_t, phi_k, impl="plain"), n=5)

    nfull, nhalf = math.prod(shape), math.prod(half)
    b_k1 = bound(nfull * 2 * 2 + wk.numel() * 4 + bk.numel() * 4 + nhalf * 64 * 2,
                 2 * 27 * 2 * 64 * nfull, BF16_TENSOR_FLOPS)
    simt_k1 = 2 * 27 * 2 * 64 * nfull / FP32_FLOPS * 1e3
    # K2: f32 flow read, bf16 payload read, bf16 written; ~16 f32 ops per
    # output value (8 products, 7 sums, the weights) on the SIMT units
    b_k2 = bound(nhalf * 3 * 4 + nhalf * 3 * 2 * 2, nhalf * 3 * 16, FP32_FLOPS)
    b_k3 = bound(nfull * 4 * 2 + nhalf * 3 * 4, nfull * (16 + 3 * 8), FP32_FLOPS)
    timing = {
        "conv3_lrelu_pool": (t_k1, t_k1p, t_k1l, b_k1),
        "warp_trilinear": (t_k2, t_k2p, t_k2l, b_k2),
        "warp_up2x": (t_k3, t_k3p, None, b_k3),
    }
    for name, (t, tp, tl, (bms, by)) in timing.items():
        print(f"#   {name}: {t:.4f} ms kernel, {tp:.4f} ms plain, "
              f"{'n/a' if tl is None else f'{tl:.4f} ms'} yardstick, bound {bms:.4f} ms ({by})")
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
    if not rehearsal:
        check(all(launches[k] >= 1 for k in launches),
              f"a kernel of the path was not launched by register(): {launches}")

    # ---- 5. report -----------------------------------------------------------
    report = []
    for k in kernels.KERNELS:
        t, tp, tl, (bms, by) = timing[k.name]
        report.append({
            "name": k.name, "route": "cuda",
            "source": f"multimodal_registration_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": results[k.name]["max_abs_err"], "ms": t, "plain_ms": tp,
            "bound_ms": bms, "bound_by": by, "library_ms": tl,
        })
    print(json.dumps({"kernels": report}))
    print(f"# forward_ms {fwd_ms:.4f} pairs_per_s {1000 / fwd_ms:.4f} peak_mib {peak:.1f} "
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
