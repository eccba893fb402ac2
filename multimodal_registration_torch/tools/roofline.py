"""Analytic roofline of the registration forward on one H100; no device needed.

    python -m multimodal_registration_torch.tools.roofline [X Y Z] [--width[=N]]

The port's counterpart of ``benchmarks/roofline.py``: per-component FLOPs and
least device-memory bytes of the flagship forward (enc [64]x4 / dec [64]x6,
svf and int res 2, ``int_steps`` 5, bf16 convs), or with ``--width`` (256
when no value is given) of those widths, at a shape (default 192^3), and
each component's speed-of-light time on the H100 SXM. Prints one JSON
object, ``{"shape", "components": {name: {"gflop", "mb", "sol_ms"}},
"total": {"gflop", "mb", "sol_ms_flops", "sol_ms_hbm"}}``.

FLOPs are the JAX script's, component for component: a 3^3 conv ``2 *
voxels * 27 * Cin * Cout``, a trilinear warp ``24 * C`` a voxel, the
rescale's fixed 0.3 GFLOP (which the total leaves out, as there).

Bytes are the least traffic of each component on the port's path: each
input read once and each output written once (bf16 activations, float32
fields and images, the weights and biases counted), not the TPU's 8C-packed
gather rows:

* a conv reads its input, weights and bias and writes its output; enc_0
  writes only the pooled tensor (kernel K1 fuses the pool, and at svf_res 2
  the full-res activation is no skip), so its output counts an eighth;
* the flow head reads the bf16 features and writes the float32 SVF;
* integrate: each squaring step reads and writes the float32 3-channel field
  (K2's fused step);
* rescale: the half-res field read, the full-res field written (the forward
  returns ``flow_fullres``);
* moved_warp: K3 reads the moving image and the half-res field and writes
  the moved image; the full-res field it stands for is never read.

Peaks (the H100 SXM data sheet, dense): 989e12 bf16 FLOP/s on the tensor
cores for the U-Net's convs, 67e12 float32 FLOP/s outside them for what runs
in float32 (the head, with TF32 off, the warps, the rescale), 3.35e12 B/s.
A component's ``sol_ms`` is the larger of its FLOPs over its type's peak and
its bytes over the memory rate; ``total.sol_ms_flops`` sums the components'
FLOP times (the rescale's left out with its FLOPs), ``total.sol_ms_hbm`` is
the total bytes over the rate.
"""

from __future__ import annotations

import json
import math
import sys

BF16 = 2
F32 = 4

PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
PEAK_F32_FLOPS = 67e12    # outside the tensor cores
PEAK_HBM = 3.35e12        # bytes/s

RESCALE_GFLOP = 0.3  # benchmarks/roofline.py's fixed count


def conv_cost(spatial, cin, cout, itemsize=BF16, out_spatial=None):
    """``(flops, bytes)`` of a 3^3 SAME conv on ``spatial``; its output is
    written at ``out_spatial`` (the pooled grid of a fused conv)."""
    vox = math.prod(spatial)
    out_vox = math.prod(out_spatial) if out_spatial else vox
    flops = 2 * vox * 27 * cin * cout
    bytes_ = (vox * cin + out_vox * cout) * itemsize + (27 * cin * cout + cout) * itemsize
    return flops, bytes_


def components(shape=(192, 192, 192), width: int = 64) -> dict:
    """``{name: {"flops", "bytes", "peak"}}`` of the forward at ``shape``,
    in the JAX script's order and names."""
    half = tuple(s // 2 for s in shape)
    enc = [width] * 4
    dec = [width] * 6
    comps = {}

    def add(name, flops, bytes_, peak):
        comps[name] = {"flops": flops, "bytes": bytes_, "peak": peak}

    # U-Net: enc at full, /2, /4, /8; dec mirrors back up to half-res (svf_res 2)
    cin = 2
    res = shape
    for i, c in enumerate(enc):
        pooled = tuple(s // 2 for s in res) if i == 0 else None
        add(f"enc_{i}@{res[0]}", *conv_cost(res, cin, c, out_spatial=pooled), PEAK_BF16_FLOPS)
        cin = c
        res = tuple(s // 2 for s in res)
    # the decoder convs first at the current resolution, then upsamples and
    # concatenates the skip; at svf_res 2 the last upsample is skipped
    n_up = len(enc) - 1
    for i, c in enumerate(dec):
        add(f"dec_{i}@{res[0]}", *conv_cost(res, cin, c), PEAK_BF16_FLOPS)
        cin = c
        if i < n_up:
            res = tuple(s * 2 for s in res)
            cin = cin + enc[len(enc) - 1 - i]
    # the float32 flow head (3 channels) at half res: bf16 features in
    hv = math.prod(half)
    add("flow_head", 2 * hv * 27 * cin * 3, hv * cin * BF16 + hv * 3 * F32
        + (27 * cin * 3 + 3) * F32, PEAK_F32_FLOPS)
    # integration: 5 squaring steps at half res, 3 channels
    add("integrate_5steps", 5 * hv * 24 * 3, 5 * hv * 3 * F32 * 2, PEAK_F32_FLOPS)
    # rescale half -> full
    vox = math.prod(shape)
    add("rescale", RESCALE_GFLOP * 1e9, (vox // 8) * 3 * F32 + vox * 3 * F32, PEAK_F32_FLOPS)
    # the moved image at full res, 1 channel, from the half-res field (K3)
    add("moved_warp", vox * 24 * 1, vox * F32 * 2 + hv * 3 * F32, PEAK_F32_FLOPS)
    return comps


def sol_ms(c: dict) -> float:
    return max(c["flops"] / c["peak"], c["bytes"] / PEAK_HBM) * 1e3


def roofline(shape=(192, 192, 192), width: int = 64) -> dict:
    """The JSON document :func:`main` prints."""
    comps = components(shape, width)
    counted = {k: c for k, c in comps.items() if k != "rescale"}  # as the JAX total
    total_f = sum(c["flops"] for c in counted.values())
    total_b = sum(c["bytes"] for c in comps.values())
    return {
        "shape": list(shape),
        "components": {k: {"gflop": round(c["flops"] / 1e9, 2), "mb": round(c["bytes"] / 1e6, 2),
                           "sol_ms": round(sol_ms(c), 6)} for k, c in comps.items()},
        "total": {
            "gflop": round(total_f / 1e9, 1),
            "mb": round(total_b / 1e6, 1),
            "sol_ms_flops": round(sum(c["flops"] / c["peak"] for c in counted.values()) * 1e3,
                                  6),
            "sol_ms_hbm": round(total_b / PEAK_HBM * 1e3, 6),
        },
    }


def parse_argv(argv) -> tuple:
    """``(shape, width)`` from ``[X Y Z] [--width[=N]]``, as the JAX script
    reads them."""
    width = 64
    args = []
    for a in argv:
        if a.startswith("--width"):
            width = int(a.split("=", 1)[1]) if "=" in a else 256
        else:
            args.append(a)
    shape = tuple(int(a) for a in args[:3]) or (192, 192, 192)
    if len(shape) != 3:
        shape = (192, 192, 192)
    return shape, width


def main(argv=None) -> dict:
    shape, width = parse_argv(sys.argv[1:] if argv is None else argv)
    out = roofline(shape, width)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
