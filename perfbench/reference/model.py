"""Plain float32 reference of the registration model (VoxelMorph ``VxmDense``
as SynthMorph trains it): a 3-D U-Net over ``[moving, fixed]``, a 3-channel
3x3x3 flow head, scaling and squaring, and the moved image.

The U-Net (VoxelMorph's topology): one 3x3x3 SAME conv and LeakyReLU(0.2) a
level, 2x max-pooling down the encoder; the decoder convs, each of the first
``len(enc) - log2(svf_res)`` followed by a nearest 2x upsample and the
concatenation ``[upsampled, skip]``; the extra decoder entries as convs at
the last resolution. Weights are a dict under the names the program's
``state_dict`` uses (``unet.enc_0.conv.weight`` ... ``flow.bias``), conv
kernels ``(Cout, Cin, 3, 3, 3)``, which the benchmark makes from the seed
and hands to both sides.

``conv`` (default: ``F.conv3d``, SAME) runs every conv of the U-Net; the
control passes one in a lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import ops


def conv_leaves(enc, dec, svf_res: int, in_channels: int = 2) -> list:
    """``[(name, cin, cout)]`` of every conv, the U-Net's then the head's."""
    nus = int(math.log2(svf_res)) if svf_res > 1 else 0
    levels = len(enc) + 1
    skip = [in_channels]
    ch = in_channels
    out = []
    for i, f in enumerate(enc):
        out.append((f"unet.enc_{i}", ch, f))
        ch = f
        skip.append(f)
    for i, f in enumerate(dec[: levels - 1]):
        out.append((f"unet.dec_{i}", ch, f))
        ch = f
        if i < levels - 1 - nus:
            ch += skip.pop()
    for j, f in enumerate(dec[levels - 1:]):
        out.append((f"unet.final_{j}", ch, f))
        ch = f
    out.append(("flow", ch, 3))
    return out


def make_weights(seed: int, model: dict, flow_head_std: float, device) -> dict:
    """Weights drawn on ``device`` from ``seed`` in two calls: every U-Net
    kernel LeCun-normal (variance ``1 / fan_in``, truncated at two stds, as
    Flax's default initialiser), biases zero, the flow head normal with std
    ``flow_head_std``. float32, under the program's state-dict names."""
    leaves = conv_leaves(model["enc"], model["dec"], model["svf_res"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    body = [(n, ci, co) for n, ci, co in leaves if n != "flow"]
    total = sum(co * ci * 27 for _, ci, co in body)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    # unit truncated normal; each kernel is scaled by its std below
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    head = torch.randn(3 * leaves[-1][1] * 27, generator=gen, device=device)
    out = {}
    at = 0
    for name, ci, co in body:
        n = co * ci * 27
        std = math.sqrt(1.0 / (ci * 27)) / 0.87962566103423978
        out[f"{name}.conv.weight"] = (flat[at: at + n] * std).reshape(co, ci, 3, 3, 3)
        out[f"{name}.conv.bias"] = torch.zeros(co, device=device)
        at += n
    out["flow.weight"] = (head * flow_head_std).reshape(3, leaves[-1][1], 3, 3, 3)
    out["flow.bias"] = torch.zeros(3, device=device)
    return out


def conv3d(x, w, b):
    return F.conv3d(x, w, b, padding=1)


def unet(weights: dict, x: torch.Tensor, model: dict, conv=conv3d) -> torch.Tensor:
    """Features ``(B, C, x, y, z)`` from ``x (B, 2, X, Y, Z)``, float32."""
    enc, dec = model["enc"], model["dec"]
    nus = int(math.log2(model["svf_res"])) if model["svf_res"] > 1 else 0
    levels = len(enc) + 1

    def block(name, v):
        return F.leaky_relu(conv(v, weights[f"unet.{name}.conv.weight"],
                                 weights[f"unet.{name}.conv.bias"]), 0.2)

    skips = [x]
    for i in range(len(enc)):
        x = block(f"enc_{i}", x)
        skips.append(x)
        x = F.max_pool3d(x, 2)
    for i in range(levels - 1):
        x = block(f"dec_{i}", x)
        if i < levels - 1 - nus:
            x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skips.pop()], 1)
    for j in range(len(dec) - (levels - 1)):
        x = block(f"final_{j}", x)
    return x


def svf(weights: dict, moving: torch.Tensor, fixed: torch.Tensor, model: dict,
        conv=conv3d) -> torch.Tensor:
    """The head's velocity field ``(B, x, y, z, 3)`` for ``(B, X, Y, Z)``
    images; the float32 head reads the U-Net's features as ``conv`` leaves
    them (``conv.features``, if it has one, rounds them)."""
    x = torch.stack([moving.float(), fixed.float()], 1)
    feat = unet(weights, x, model, conv)
    feat = getattr(conv, "features", lambda f: f)(feat)
    v = F.conv3d(feat, weights["flow.weight"], weights["flow.bias"], padding=1)
    return v.permute(0, 2, 3, 4, 1)


def _check(model: dict) -> None:
    if model["svf_res"] != 2 or model["int_res"] != 2:
        raise NotImplementedError("the reference follows svf_res = int_res = 2 only")


def _payload(model: dict):
    """The type the integration gathers its values in, as the configuration
    states it (``integrate_payload_dtype``: a storage format of the
    algorithm, not the precision of its arithmetic); None: float32."""
    return getattr(torch, model["payload"]) if model.get("payload") else None


def forward(weights: dict, moving: torch.Tensor, fixed: torch.Tensor, model: dict) -> tuple:
    """``(moved (B, X, Y, Z), warp (B, x, y, z, 3))`` as ``predict`` returns
    them: the half-grid field integrated, the moving image warped by its
    corner-aligned 2x upsample."""
    _check(model)
    phi = ops.integrate(svf(weights, moving, fixed, model), model["int_steps"],
                        _payload(model))
    full = ops.upsample2x_field(phi, tuple(moving.shape[1:4]))
    moved = ops.warp(moving.float()[..., None], full)[..., 0]
    return moved, phi


def train_forward(weights: dict, moving: torch.Tensor, fixed: torch.Tensor, model: dict,
                  conv=conv3d) -> tuple:
    """``(warp, flow_fullres)`` with gradients, for the training loss."""
    _check(model)
    phi = ops.integrate(svf(weights, moving, fixed, model, conv), model["int_steps"],
                        _payload(model))
    return phi, ops.upsample2x_field(phi, tuple(moving.shape[1:4]))
