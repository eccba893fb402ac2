"""int8 3x3x3 SAME conv + dequantization + bias + LeakyReLU: the wrapper of
kernel K8 (``conv3_int8``) and its plain version.

Counterpart of ``multimodal_registration_tpu/models/unet.py::ConvBlock._int8_conv``
(XLA there, no Pallas kernel). It computes exactly, in this order:

  * ``w_scale = max(max|w| over (Cin, 3, 3, 3), 1e-12) / 127`` per output
    channel and ``wq = clip(round(w / w_scale), +-127)`` (a division), from
    the float32 parameters;
  * ``a_scale = max(amax, 1e-12) / 127`` and ``xq = clip(round(x_f32 *
    (1 / a_scale)), +-127)`` (a product with the reciprocal, taken once in
    float32);
  * the int8 x int8 -> int32 conv (the sums are exact integers);
  * ``leaky_relu(sums_f32 * (a_scale * w_scale) + b, slope)`` in float32,
    the product of the scales taken first, one rounding per operation, then
    the cast to the compute type.

Both roundings are half to even (``torch.round``; ``rintf`` in the kernel).
The plain version sums the integer products in float64, tap by tap: every
partial sum is an integer below ``27 * 512 * 127**2 < 2**53``, so the sums
are exact (float32 would not be, above ``2**24``). On the card the weights
are quantized and laid out once per parameter version, activation scale and
stream (:func:`prepared_int8_weights`), and a call is two launches: the
quantize pass, then the conv (``csrc/conv_int8.cu``). Inference only, as in
the JAX package: asked for a gradient on the card, the wrapper raises.

The conv kernel's tiling is computed here, by :class:`Int8ConvPlan`, and
handed to the launcher, which checks it against the kernel's constants: a
block owns a box of 2 (x) x 4 (y) x 16 (z) output voxels and 256 output
channels; for each chunk of 64 input channels it stages, for each dz in
{-1, 0, 1}, the halo box of 4 x 6 x 16 voxels at (x0 - 1, y0 - 1, z0 + dz),
zeros outside the volume; tap (dx, dy, dz) of the x-plane ``xo`` of the box
is then the 64 consecutive rows of the dz plane from :meth:`Int8ConvPlan.tap_row`.
Two blocks (a cluster) own consecutive boxes and share each weight tile.
``tests/test_torch_conv_int8_tiling.py`` walks this tiling on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_registration_torch import kernels
from multimodal_registration_torch.ops.warp import needs_grad, use_kernel

_K_CHUNK = 64  # input channels of one k-chunk of the kernel; Cin is padded to a multiple
_N_TILE = 256  # output channels of one block of the kernel; Cout is padded to a multiple
_MODES = {torch.int32: 0, torch.bfloat16: 1, torch.float32: 2}
BOX = (2, 4, 16)  # output voxels of a block along x, y, z: one 64-row tile per x-plane
HALO = (BOX[0] + 2, BOX[1] + 2, BOX[2])  # a dz plane of the staged halo (z shifted by dz)
CLUSTER = 2  # blocks that share each weight tile


def act_scales(amax) -> tuple[float, float]:
    """``(a_scale, 1 / a_scale)`` in float32 for a calibrated ``amax``."""
    a = np.maximum(np.float32(amax), np.float32(1e-12)) / np.float32(127.0)
    return float(a), float(np.float32(1.0) / a)


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``w (Cout, Cin, 3, 3, 3)`` -> ``(wq int8 of the same shape, w_scale
    (Cout,) float32)``, symmetric per output channel."""
    k = w.detach().float()
    # a true division, as the JAX package's: on CUDA, PyTorch divides by a
    # Python number as a product with its reciprocal, one bit off at times
    w_scale = (torch.clamp(k.abs().amax(dim=(1, 2, 3, 4)), min=1e-12)
               / torch.tensor(127.0, device=k.device))
    wq = torch.clamp(torch.round(k / w_scale[:, None, None, None, None]), -127, 127)
    return wq.to(torch.int8), w_scale


def quantize_act(x: torch.Tensor, amax) -> torch.Tensor:
    """``clip(round(x_f32 * (1 / a_scale)), +-127)`` as int8."""
    _, inv = act_scales(amax)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def int8_conv_sums_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of the 3x3x3 SAME conv of ``xq (B, X, Y, Z, Cin)``
    and ``wq (Cout, Cin, 3, 3, 3)``, both int8: 27 float64 matrix products of
    the integer values, one per tap."""
    B, X, Y, Z, Cin = xq.shape
    xp = F.pad(xq.double(), (0, 0, 1, 1, 1, 1, 1, 1))
    wt = wq.double().permute(2, 3, 4, 1, 0)  # (3, 3, 3, Cin, Cout)
    acc = None
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                tap = xp[:, dx:dx + X, dy:dy + Y, dz:dz + Z].reshape(-1, Cin) @ wt[dx, dy, dz]
                acc = tap if acc is None else acc.add_(tap)
    return acc.reshape(B, X, Y, Z, -1).to(torch.int32)


def dequant_scale(w_scale: torch.Tensor, amax) -> torch.Tensor:
    """``a_scale * w_scale`` per output channel, float32."""
    a_scale, _ = act_scales(amax)
    return torch.tensor(a_scale, dtype=torch.float32, device=w_scale.device) * w_scale


def _check(x, w, b):
    if x.ndim != 5 or w.shape[1:] != (x.shape[-1], 3, 3, 3) or b.shape != (w.shape[0],):
        raise ValueError(
            f"conv3_int8: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} "
            "do not fit")


def conv3_int8_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, amax,
                     neg_slope: float = 0.2, sums: bool = False) -> torch.Tensor:
    """Plain version of :func:`conv3_int8`: ``x (B, X, Y, Z, Cin)``, ``w
    (Cout, Cin, 3, 3, 3)``, ``b (Cout,)`` -> ``(B, X, Y, Z, Cout)`` in ``x``'s
    type (with ``sums`` the int32 sums before the dequantization)."""
    _check(x, w, b)
    wq, w_scale = quantize_weights(w)
    s = int8_conv_sums_plain(quantize_act(x, amax), wq)
    if sums:
        return s
    # one rounding per operation, the scales' product first
    y = s.float() * dequant_scale(w_scale, amax) + b.float()
    return F.leaky_relu(y, neg_slope).to(x.dtype)


def gemm_int8_weights(wq: torch.Tensor, cp: int) -> torch.Tensor:
    """The kernel's B operand: ``wq (Cout, Cin, 3, 3, 3)`` int8 as a matrix
    ``(Cout_pad, 27 * cp)``, row ``n``, column ``k = tap * cp + ci`` with
    ``tap = (dx * 3 + dy) * 3 + dz``; Cin padded with zero channels to ``cp``,
    Cout with zero rows to a multiple of the block's 256 output channels."""
    cout, cin = wq.shape[:2]
    m = F.pad(wq.permute(0, 2, 3, 4, 1), (0, cp - cin))  # (Cout, 3, 3, 3, cp)
    return F.pad(m.reshape(cout, 27 * cp), (0, 0, 0, -cout % _N_TILE)).contiguous()


def padded_cin(cin: int) -> int:
    return -(-cin // _K_CHUNK) * _K_CHUNK


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Int8ConvPlan:
    """The conv kernel's tiling of ``x (B, X, Y, Z, Cin)`` -> ``Cout``
    channels: what the launcher is given and what the kernel computes from
    it. Boxes are numbered with z fastest, then y, x and the batch; tile
    ``t`` is box pair ``t // n_blocks_n`` (boxes ``2 p`` and ``2 p + 1``, the
    two blocks of a cluster) at output channels ``256 (t % n_blocks_n)``.
    A last box without a partner leaves the second block of its cluster
    idle: it loads zeros and stores nothing."""

    def __init__(self, shape, cout: int):
        self.B, self.X, self.Y, self.Z, self.cin = (int(s) for s in shape)
        self.cout = int(cout)
        self.cp = padded_cin(self.cin)
        self.chunks = self.cp // _K_CHUNK
        self.cout_pad = _cdiv(self.cout, _N_TILE) * _N_TILE
        self.n_blocks_n = self.cout_pad // _N_TILE
        self.boxes_xyz = (_cdiv(self.X, BOX[0]), _cdiv(self.Y, BOX[1]), _cdiv(self.Z, BOX[2]))
        self.n_boxes = self.B * self.boxes_xyz[0] * self.boxes_xyz[1] * self.boxes_xyz[2]
        self.n_pairs = _cdiv(self.n_boxes, CLUSTER)
        self.n_tiles = self.n_pairs * self.n_blocks_n

    def tile(self, t: int, rank: int) -> tuple[int, int]:
        """``(box, first output channel)`` of block ``rank`` of the cluster
        that takes tile ``t``; ``box >= n_boxes`` is an idle block."""
        return CLUSTER * (t // self.n_blocks_n) + rank, _N_TILE * (t % self.n_blocks_n)

    def box_origin(self, box: int) -> tuple[int, int, int, int]:
        """``(b, x0, y0, z0)`` of output box ``box`` (``b == B`` past the last)."""
        nbx, nby, nbz = self.boxes_xyz
        r, bz = divmod(box, nbz)
        r, by = divmod(r, nby)
        b, bx = divmod(r, nbx)
        return b, bx * BOX[0], by * BOX[1], bz * BOX[2]

    def halo_origin(self, box: int, dz: int) -> tuple[int, int, int, int]:
        """``(b, x, y, z)`` of the first voxel of the staged dz plane
        (``dz`` in -1, 0, 1); voxels outside the volume read as zeros."""
        b, x0, y0, z0 = self.box_origin(box)
        return b, x0 - 1, y0 - 1, z0 + dz

    @staticmethod
    def tap_row(xo: int, dx: int, dy: int) -> int:
        """First row of the dz plane (rows of 64 channels, ``(x, y, z)``
        row-major over ``HALO``) that tap ``(dx, dy, .)`` of x-plane ``xo``
        of the box reads: its 64 rows ``(yi, zi)`` are consecutive."""
        return ((xo + 1 + dx) * HALO[1] + 1 + dy) * HALO[2]

    def weight_col(self, tap: int, chunk: int) -> int:
        """First column of the weight matrix (:func:`gemm_int8_weights`)
        for tap ``(dx + 1) * 9 + (dy + 1) * 3 + dz + 1`` and input chunk ``chunk``."""
        return tap * self.cp + chunk * _K_CHUNK

    def launch_args(self) -> tuple:
        """The tiling arguments of ``conv3_int8_launch``, after the shape."""
        return (self.cp, self.cout, self.cout_pad, *BOX, *self.boxes_xyz, self.n_tiles)


# (data_ptr, _version) of w and b, amax, device, stream -> (w, b, matrix, scale, bias)
_PREPARED: dict = {}
_PREPARED_MAX = 32  # a device's: the nine int8 convs of each of the cascade's two models


def prepared_int8_weights(w: torch.Tensor, b: torch.Tensor, amax):
    """The kernel's operands, made once per version of the parameters, per
    activation scale and per stream (as ``ops/conv_pool.py::prepared_weights``
    makes K1's): the int8 matrix of :func:`gemm_int8_weights`, ``scale =
    a_scale * w_scale`` and the bias, both float32 padded like the matrix's
    rows. An entry keeps ``w`` and ``b`` alive; each device holds at most
    ``_PREPARED_MAX`` entries, its oldest going first, so a mesh of several
    cards keeps every card's; inference tensors track no version and are
    prepared anew on every call."""
    try:
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version, float(np.float32(amax)),
               w.device, kernels.stream_of(w) if w.is_cuda else 0, w.shape)
    except RuntimeError:  # inference tensors do not track a version
        key = None
    entry = _PREPARED.get(key)
    if entry is None:
        with torch.no_grad():
            wq, w_scale = quantize_weights(w)
            pad = -w.shape[0] % _N_TILE
            entry = (w, b, gemm_int8_weights(wq, padded_cin(w.shape[1])),
                     F.pad(dequant_scale(w_scale, amax), (0, pad)).contiguous(),
                     F.pad(b.float(), (0, pad)).contiguous())
        if key is not None:
            mine = [k for k in _PREPARED if k[5] == w.device]
            if len(mine) >= _PREPARED_MAX:
                del _PREPARED[mine[0]]
            _PREPARED[key] = entry
    return entry[2:]


def conv3_int8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, amax,
               neg_slope: float = 0.2, impl=None, sums: bool = False) -> torch.Tensor:
    """``leaky_relu(int8_conv3x3x3_SAME(x, w) * a_scale * w_scale + b)`` in
    ``x``'s type (float32 or bfloat16): ``x (B, X, Y, Z, Cin)``, ``w (Cout,
    Cin, 3, 3, 3)`` float32 parameters, ``b (Cout,)``, ``amax`` the calibrated
    activation scale (a number). With ``sums`` the int32 sums before the
    dequantization."""
    _check(x, w, b)
    if not use_kernel(x, impl):
        return conv3_int8_plain(x, w, b, amax, neg_slope, sums)
    if needs_grad(x, w, b):
        raise NotImplementedError(
            "conv3_int8 (kernel K8) is inference-only, as the JAX package's int8 path: "
            "call it under torch.no_grad()")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3_int8: x must be float32 or bfloat16, got {x.dtype}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3_int8: x, w and b on different devices")
    B, X, Y, Z, Cin = x.shape
    plan = Int8ConvPlan(x.shape, w.shape[0])
    wk, scale, bias = prepared_int8_weights(w, b, amax)
    _, inv = act_scales(amax)
    x = x.contiguous()
    xq = torch.empty((B, X, Y, Z, plan.cp), dtype=torch.int8, device=x.device)
    out = torch.empty((B, X, Y, Z, plan.cout), dtype=torch.int32 if sums else x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    stream = kernels.stream_of(x)
    with kernels.on_device_of(x):
        kernels.CONV3_INT8.launch_entry(
            "quantize_act_launch", x.data_ptr(), xq.data_ptr(), B * X * Y * Z, Cin, plan.cp, inv,
            int(x.dtype == torch.bfloat16), stream, count=False)
        kernels.CONV3_INT8.launch(
            xq.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, X, Y, Z, *plan.launch_args(), _MODES[out.dtype], float(neg_slope), stream)
    return out
