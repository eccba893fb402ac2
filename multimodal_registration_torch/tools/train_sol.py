"""Speed-of-light itemisation of the training step on one H100.

    python -m multimodal_registration_torch.tools.train_sol [--small] [--iters N]
        [--device cpu] [--out FILE]

The port's counterpart of ``benchmarks/train_sol.py``: each synthesis stage
of one image (the engine at ``svf_int_res`` 4, ``TrainConfig``'s default;
a step synthesises two) and the model's forward and forward + backward,
timed in isolation at the reference workload (160x160x192, 26 labels;
``--small`` 32x32x48, 8 labels), each beside an analytic floor: the larger
of its least bytes (each input read once, each output written once) over
3.35e12 B/s and its operations over the H100 SXM's peak for their type
(``tools/roofline.py``). Where a port kernel does the stage's work, the
floor is that kernel's bound as ``chip_smoke.py`` computes it (PERF.md
section 6): K2's fused squaring step (float32 field read and written a
step) for the integration, K6's (the soft map and the hard labels written,
the flow and the labels read) for the label warp. The model's floors come
from ``tools/roofline.py`` at the workload's shape: the forward up to the
integrated warp, and three times it with the backward (a conv's data and
weight gradients each cost its forward).

The row names are the JAX script's; the port's bodies are its own (K6 for
the label warp, a gather for the intensity lookup). One row is the port's
own, last: the training loss's Dice, fused (K6's and K7's Dice entries),
forward and gradient w.r.t. the flow, its floor the forward's bytes (the
target map, the flow and the labels read) plus the backward's least bytes
(one target entry a voxel, the flow and the labels read, the gradient
written). Each row is timed as the
best of 2 blocks of ``--iters`` calls (half as many, at least 2, for the
model) after a warm-up call, chained on one ``torch.Generator`` where it
draws. Prints the table, then writes ``{"workload", "labels", "svf_int_res",
"rows": [{"stage", "ms", "floor_ms", "floor"}]}`` to ``--out`` (nowhere by
default). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from multimodal_registration_torch.device import full_fp32_convs, resolve_device
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.ops.integrate import integrate_svf
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_labels_soft_hard, warp_onehot_dice_batch
from multimodal_registration_torch.synth.augment import random_flips
from multimodal_registration_torch.synth.image_engine import (
    ImageEngineConfig,
    _gaussian_blur,
    _vel_scales,
    payload_dtype,
)
from multimodal_registration_torch.synth.perlin import draw_perlin, sample_shapes
from multimodal_registration_torch.tools import roofline
from multimodal_registration_torch.tools.timing import (
    card_note, ms_per_call, note, write_result)
from multimodal_registration_torch.train.trainer import init_like_flax_

F32 = 4
HBM = roofline.PEAK_HBM
DICE_ROW = "dice loss, fused (fwd + grad wrt flow)"  # the port's own, after the JAX rows


def stream_s(nbytes: float) -> float:
    return nbytes / HBM


def model_floor_s(shape) -> float:
    """The forward to the integrated warp at ``shape``: the larger of its
    operations at their types' peaks and its least bytes."""
    comps = roofline.components(shape, 64)
    used = [c for k, c in comps.items() if k not in ("rescale", "moved_warp")]
    return max(sum(c["flops"] / c["peak"] for c in used), sum(c["bytes"] for c in used) / HBM)


def run(iters: int = 8, small: bool = False, device=None, emit=print) -> dict:
    """Time the rows; ``emit`` gets the printed table's lines."""
    dev = resolve_device(device)
    shape, L = ((32, 32, 48), 8) if small else ((160, 160, 192), 26)
    ecfg = ImageEngineConfig(num_labels=L, svf_int_res=4)
    r = ecfg.svf_int_res
    small_grid = tuple(s // r for s in shape)
    V, Vs = math.prod(shape), math.prod(small_grid)
    rs = np.random.RandomState(0)
    lab = torch.as_tensor(rs.randint(0, L, shape).astype(np.int32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []  # (stage, ms, floor ms, floor kind)

    def add(name, fn, floor_s, kind, n=iters):
        rows.append((name, ms_per_call(dev, fn, n, blocks=2), floor_s * 1e3, kind))

    with torch.no_grad():
        scales = _vel_scales(ecfg, r)

        def f_draw():
            return draw_perlin(gen, (*small_grid, 3), scales, max_std=ecfg.vel_std, device=dev)

        noise = sum(math.prod(s) for s in sample_shapes((*small_grid, 3), scales))
        # the noise drawn (written) and read by the resize, the SVF written
        add("svf draw (perlin, /4 grid)", f_draw, stream_s((2 * noise + 3 * Vs) * F32), "bytes")

        svf = f_draw()
        pd = payload_dtype(ecfg)
        add("svf integrate (5 sq, /4 grid)",
            lambda: integrate_svf(svf / r, ecfg.int_steps, pd),
            stream_s(ecfg.int_steps * Vs * 3 * F32 * 2), "K2 bound (bytes)")

        phi_s = integrate_svf(svf / r, ecfg.int_steps, pd)
        add("phi upsample /4 -> full", lambda: rescale_field(phi_s, float(r), out_shape=shape),
            stream_s(3 * (Vs + V) * F32), "bytes")

        phi = rescale_field(phi_s, float(r), out_shape=shape)
        # written: the soft map (L float32) and the hard labels (int32);
        # read: the float32 flow and the int32 labels
        add("label warp (soft+hard, packed)", lambda: warp_labels_soft_hard(lab, phi, L),
            stream_s(V * (L * F32 + F32 + 3 * F32 + F32)), "K6 bound (bytes)")

        _, lab_idx = warp_labels_soft_hard(lab, phi, L)

        def f_lookup():
            means = 25.0 + 200.0 * torch.rand((L,), generator=gen, device=dev)
            stds = 5.0 + 20.0 * torch.rand((L,), generator=gen, device=dev)
            idx = lab_idx.long()
            return means[idx] + stds[idx] * torch.randn(shape, generator=gen, device=dev)

        # the labels read, the noise drawn, the image written
        add(f"intensity lookup ({L}-way select)+noise", f_lookup, stream_s(3 * V * F32), "bytes")

        img = f_lookup()

        def f_blur():
            sigma = ecfg.blur_std * torch.rand((), generator=gen, device=dev)
            return _gaussian_blur(img, sigma, ecfg.blur_radius)

        add("blur (shifts, r=3, 3 axes)", f_blur, stream_s(2 * V * F32), "bytes")

        def f_bias():
            bias = draw_perlin(gen, (*shape, 1), [ecfg.bias_res], max_std=ecfg.bias_std,
                               device=dev)
            return img * torch.exp(bias[..., 0])

        add("bias field (perlin+exp+mul)", f_bias, stream_s(2 * V * F32), "bytes")

        def f_norm_gamma():
            lo, hi = img.min(), img.max()
            im = (img - lo) / torch.clamp(hi - lo, min=1e-7)
            g = torch.exp(0.25 * torch.randn((), generator=gen, device=dev))
            return torch.pow(torch.clamp(im, 1e-7, 1.0), g)

        add("min-max norm + gamma pow", f_norm_gamma, stream_s(2 * V * F32), "bytes")
        add("random flips (pair)", lambda: random_flips(gen, (img, img)),
            stream_s(4 * V * F32), "bytes")

    vcfg = VxmConfig(enc=(64,) * 4, dec=(64,) * 6, int_steps=5, int_res=2, svf_res=2,
                     compute_dtype="float32" if small else "bfloat16")
    model = VxmDense(vcfg, device=dev)
    init_like_flax_(model, 0)
    mov = torch.as_tensor(rs.rand(1, *shape, 1).astype(np.float32), device=dev)
    fx = torch.as_tensor(rs.rand(1, *shape, 1).astype(np.float32), device=dev)
    params = list(model.parameters())

    def warp_sq():
        return (model(mov, fx, with_moved=False, with_fullres=False)["warp"] ** 2).sum()

    def f_bwd():
        s = warp_sq()
        with full_fp32_convs():
            return torch.autograd.grad(s, params)

    fwd_floor = model_floor_s(shape)
    n_model = max(2, iters // 2)
    with torch.no_grad():
        add("model fwd (U-Net+int, to warp)", warp_sq, fwd_floor, "roofline (operations)",
            n_model)
    add("model fwd+bwd (grad wrt params)", f_bwd, 3 * fwd_floor, "3x the forward's roofline",
        n_model)

    # the port's own row: the training loss's Dice, fused, forward and flow
    # gradient, against a soft target; its floor the forward's bound (t, the
    # flow and the labels read) and the backward's least bytes (one t entry a
    # voxel, the flow and the labels read, the gradient written)
    with torch.no_grad():
        tmap = warp_labels_soft_hard(lab, phi * 0.5, L)[0][None]
    fl = phi.detach().clone().requires_grad_()

    def f_dice():
        d = warp_onehot_dice_batch(lab[None], fl[None], tmap, L)
        return torch.autograd.grad(d, fl)

    add(DICE_ROW, f_dice, stream_s(V * (L * F32 + 3 * F32 + F32) + V * (F32 + 3 * F32 + F32 + 3 * F32)),
        "K6 + K7 Dice bounds (bytes)")
    del tmap

    emit(f"\nworkload {shape} / {L} labels, svf_int_res={r}  (per-image synthesis stages; "
         f"a step synthesizes 2 images)\n")
    emit(f"{'stage':44s} {'measured':>10s} {'floor':>9s}  floor kind")
    for name, ms, fms, kind in rows:
        emit(f"{name:44s} {ms:8.3f}ms {fms:8.4f}ms  {kind}")
    return {"workload": list(shape), "labels": L, "svf_int_res": r,
            "rows": [{"stage": n, "ms": m, "floor_ms": f, "floor": k} for n, m, f, k in rows]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="32x32x48 / 8 labels")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the rows to this JSON file")
    return ap


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    dev = resolve_device(a.device)
    note(card_note(dev))
    out = run(a.iters, a.small, dev)
    write_result(a.out, out)
    return out


if __name__ == "__main__":
    main()
