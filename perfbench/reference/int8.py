"""Plain int8 reference of the registration model's int8 mode (the
configuration's ``quantize: "int8"``): the float32 reference of
``reference/model.py`` with every conv whose input has at least ``MIN_CIN``
channels run as an int8 conv, with scales calibrated here.

The layer's equations, as the configuration states them (the port's
``ops/conv_int8.py`` writes them down; this file follows the equations, not
that code):

* weights symmetric int8 per output channel: ``w_scale = max(max|w| over
  (Cin, 3, 3, 3), 1e-12) / 127`` (a true division) and ``wq = clip(round(w /
  w_scale), +-127)``;
* activations int8 per tensor: ``a_scale = max(amax, 1e-12) / 127`` and
  ``xq = clip(round(x * (1 / a_scale)), +-127)``, the reciprocal taken once;
* the sums of the integer products, exact;
* ``leaky_relu(sums * (a_scale * w_scale) + b, 0.2)``, float32, one rounding
  per operation, the scales' product first. Rounding is half to even.

``amax`` is ``MARGIN`` times the largest ``|x|`` of the conv's input over
the float32 reference forward of the calibration pairs (:func:`calibrate`).

The sums never come from ``F.conv3d``: cuDNN may choose a Winograd or FFT
algorithm, whose transforms round. They are float32 matrix products of the
27 tap-shifted copies of ``CHUNK`` input channels at a time: every partial
sum is an integer of magnitude at most ``27 * 32 * 127**2 < 2**24``, so a
float32 product sums it exactly in any order (TF32 off, ``ops.no_tf32``);
the chunks add up in float64, exact below ``2**53``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref_model
from perfbench.reference import ops

MARGIN = 1.25
MIN_CIN = 64
CHUNK = 32
TAPS = [(dx, dy, dz) for dx in range(3) for dy in range(3) for dz in range(3)]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def quantize_weights(w: torch.Tensor) -> tuple:
    """``w (Cout, Cin, 3, 3, 3)`` -> ``(wq int8, w_scale (Cout,) float32)``."""
    k = w.detach().float()
    peak = k.abs().flatten(1).max(dim=1).values
    w_scale = torch.maximum(peak, _f32(1e-12).to(k.device)) / _f32(127.0).to(k.device)
    wq = torch.clamp(torch.round(k / w_scale[:, None, None, None, None]), -127, 127)
    return wq.to(torch.int8), w_scale


def act_scale(amax) -> tuple:
    """``(a_scale, 1 / a_scale)``, float32 0-d tensors on the CPU."""
    a = torch.maximum(_f32(amax), _f32(1e-12)) / _f32(127.0)
    return a, _f32(1.0) / a


def quantize_act(x: torch.Tensor, amax) -> torch.Tensor:
    """``x`` as int8 with the activation scale of ``amax``."""
    _, inv = act_scale(amax)
    return torch.clamp(torch.round(x.float() * inv.to(x.device)), -127, 127).to(torch.int8)


def conv_sums(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact sums of the 3x3x3 zero-padded conv of ``xq (B, Cin, X, Y,
    Z)`` and ``wq (Cout, Cin, 3, 3, 3)``, both int8: float64 ``(B, Cout, X,
    Y, Z)``."""
    B, cin, X, Y, Z = xq.shape
    cout = wq.shape[0]
    xp = F.pad(xq.float(), (1, 1, 1, 1, 1, 1)).permute(0, 2, 3, 4, 1)  # (B, X+2, Y+2, Z+2, Cin)
    wt = wq.float().permute(2, 3, 4, 1, 0)  # (3, 3, 3, Cin, Cout)
    acc = torch.zeros((B * X * Y * Z, cout), dtype=torch.float64, device=xq.device)
    for c0 in range(0, cin, CHUNK):
        c1 = min(c0 + CHUNK, cin)
        cols = torch.stack([xp[:, dx:dx + X, dy:dy + Y, dz:dz + Z, c0:c1] for dx, dy, dz in TAPS],
                           -2).reshape(-1, 27 * (c1 - c0))
        acc += (cols @ wt[..., c0:c1, :].reshape(27 * (c1 - c0), cout)).double()
        del cols
    return acc.reshape(B, X, Y, Z, cout).permute(0, 4, 1, 2, 3)


def int8_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, amax) -> torch.Tensor:
    """The int8 layer before its activation: ``sums * (a_scale * w_scale) +
    b``, float32 ``(B, Cout, X, Y, Z)`` for ``x (B, Cin, X, Y, Z)``."""
    wq, w_scale = quantize_weights(w)
    a_scale, _ = act_scale(amax)
    scale = a_scale.to(w_scale.device) * w_scale
    s = conv_sums(quantize_act(x, amax), wq).float()
    return s * scale[:, None, None, None] + b.float()[:, None, None, None]


def _block_names(weights: dict) -> dict:
    """``id`` of each U-Net conv kernel -> its block's name (``unet.enc_1``)."""
    return {id(v): k[: -len(".conv.weight")] for k, v in weights.items()
            if k.startswith("unet.") and k.endswith(".conv.weight")}


class Recorder:
    """A ``conv`` for ``reference/model.py::unet``: the float32 conv, and
    the running ``max|x|`` of each quantizable conv's input."""

    def __init__(self, weights: dict):
        self.names = _block_names(weights)
        self.peak = {}

    def __call__(self, x, w, b):
        if w.shape[1] >= MIN_CIN:
            name = self.names[id(w)]
            m = x.abs().max()
            self.peak[name] = m if name not in self.peak else torch.maximum(self.peak[name], m)
        return ref_model.conv3d(x, w, b)


class Int8Conv:
    """A ``conv`` for ``reference/model.py::unet``: the int8 layer with the
    calibrated ``amax`` (by block name) where the input has at least
    ``MIN_CIN`` channels, the float32 conv elsewhere."""

    def __init__(self, weights: dict, amax: dict):
        self.names = _block_names(weights)
        self.amax = amax

    def __call__(self, x, w, b):
        if w.shape[1] < MIN_CIN:
            return ref_model.conv3d(x, w, b)
        return int8_conv(x, w, b, self.amax[self.names[id(w)]])


def calibrate(weights: dict, pairs, model: dict) -> dict:
    """``{block: amax}`` (float32 numbers): ``MARGIN`` times each
    quantizable conv's largest input ``|x|`` over the float32 reference
    forward of ``pairs``, ``(moving, fixed)`` each ``(B, X, Y, Z)``."""
    rec = Recorder(weights)
    with torch.no_grad():
        for mov, fix in pairs:
            ref_model.unet(weights, torch.stack([mov.float(), fix.float()], 1), model, rec)
    return {k: float(v.float().cpu() * _f32(MARGIN)) for k, v in rec.peak.items()}


def forward(weights: dict, moving: torch.Tensor, fixed: torch.Tensor, model: dict,
            amax: dict) -> tuple:
    """``(moved (B, X, Y, Z), warp (B, x, y, z, 3))`` of the int8 model, as
    ``reference/model.py::forward`` gives them for the float32 one."""
    if model["svf_res"] != 2 or model["int_res"] != 2:
        raise NotImplementedError("the reference follows svf_res = int_res = 2 only")
    payload = getattr(torch, model["payload"]) if model.get("payload") else None
    with torch.no_grad():
        v = ref_model.svf(weights, moving, fixed, model, Int8Conv(weights, amax))
        phi = ops.integrate(v, model["int_steps"], payload)
        full = ops.upsample2x_field(phi, tuple(moving.shape[1:4]))
        moved = ops.warp(moving.float()[..., None], full)[..., 0]
    return moved, phi

