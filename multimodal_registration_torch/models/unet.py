"""3-D U-Net backbone, mirroring the VoxelMorph U-Net topology.

Counterpart of ``multimodal_registration_tpu/models/unet.py`` (the z-tap
Conv2D lowering, a TPU layout workaround, is not ported):

  * encoder: one 3³ conv + LeakyReLU(0.2) per level, 2x max-pool between
    levels;
  * decoder: one 3³ conv + LeakyReLU per level; after each of the first
    ``len(enc) - nb_upsample_skips`` decoder levels, 2x nearest upsampling
    and skip concatenation in ``[upsampled, skip]`` order;
  * remaining ``dec[len(enc):]`` entries are extra convs at the final
    resolution.

Activations are channels-last ``(B, X, Y, Z, C)`` like the JAX package's;
the convs see them as NCDHW views with channels-last strides. With
``nb_upsample_skips >= 1`` the decoder never reads enc_0's full-res
activation, so in inference enc_0 runs as kernel K1 (``ops/conv_pool.py``),
which writes only the pooled tensor. K1 has no backward: whenever a gradient
is needed (grad mode on and a parameter or the input requires one) enc_0 is
the unfused conv + ``max_pool_2x``, as in the JAX trainer. The other convs
are ``F.conv3d`` (cuDNN), as the JAX package leaves them to XLA; in float32
they run in full float32, not cuDNN's default TF32. ``pool_tie`` is the tie
rule of the pools' backward (``ops/pool.py``).

int8 inference (``quant="int8"``): a block whose input has at least
``quant_min_cin`` (64) channels runs the int8 conv, kernel K8
(``ops/conv_int8.py``), with the calibrated activation scale ``amax`` of its
input; thinner blocks and the fused enc_0 stay in the compute type. In
calibration mode (``calibrating``) such a block records the running
``max|x|`` of its input in float32 and runs the normal conv.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.ops.conv_int8 import conv3_int8
from multimodal_registration_torch.ops.conv_pool import conv3_lrelu_pool
from multimodal_registration_torch.ops.pool import max_pool_2x
from multimodal_registration_torch.ops.warp import needs_grad


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class ConvBlock(nn.Module):
    """3³ SAME conv + LeakyReLU(0.2) in the compute ``dtype`` (float32
    parameters, cast per call like Flax's ``nn.Conv(dtype=...)``), or the
    int8 conv when ``quant == "int8"`` and ``cin >= quant_min_cin``
    (``quantizable``; ``amax`` then holds the activation scale)."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16, device=None,
                 quant: str = "", quant_min_cin: int = 64):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv3d(cin, cout, 3, padding=1, device=device)
        self.quantizable = quant == "int8" and cin >= quant_min_cin
        self.amax = None        # calibrated max|x| of the input (a float32 number)
        self.calibrating = False
        self.recorded = None    # running max|x| of the calibration (a device scalar)

    def forward(self, x, impl=None):
        if self.quantizable and self.calibrating:
            m = x.float().abs().amax()
            self.recorded = m if self.recorded is None else torch.maximum(self.recorded, m)
        elif self.quantizable:
            if self.amax is None:
                raise ValueError(
                    "quantize='int8' needs calibrated activation scales: apply "
                    "with a 'quant' collection (models/quantize.py::calibrate_scales)")
            return conv3_int8(x.to(self.dtype), self.conv.weight, self.conv.bias, self.amax,
                              0.2, impl=impl)
        w = self.conv.weight.to(self.dtype)
        b = self.conv.bias.to(self.dtype)
        # in float32, cuDNN would otherwise run the conv in TF32 (fault F5)
        with full_fp32_convs() if self.dtype == torch.float32 else contextlib.nullcontext():
            y = F.conv3d(_ncdhw(x.to(self.dtype)), w, b, padding=1)
        return _ndhwc(F.leaky_relu(y, 0.2))

    def forward_pooled(self, x, impl=None):
        """``max_pool_2x(forward(x))`` through kernel K1, never writing the
        full-res activation."""
        return conv3_lrelu_pool(x.to(self.dtype), self.conv.weight, self.conv.bias,
                                0.2, impl=impl)


def _upsample_nearest_2x(x):
    # (B, X, Y, Z, C) -> (B, 2X, 2Y, 2Z, C); Keras UpSampling3D parity
    return _ndhwc(F.interpolate(_ncdhw(x), scale_factor=2, mode="nearest"))


class Unet(nn.Module):
    def __init__(self, in_channels: int, enc_nf, dec_nf, nb_upsample_skips: int = 0,
                 dtype=torch.bfloat16, device=None, quant: str = ""):
        super().__init__()
        self.enc_nf, self.dec_nf = tuple(enc_nf), tuple(dec_nf)
        self.nb_upsample_skips = nb_upsample_skips
        self.dtype = dtype
        nb_levels = len(self.enc_nf) + 1
        skip_ch = [in_channels]
        ch = in_channels
        for i, f in enumerate(self.enc_nf):
            self.add_module(f"enc_{i}", ConvBlock(ch, f, dtype, device, quant))
            ch = f
            skip_ch.append(f)
        for i, f in enumerate(self.dec_nf[: nb_levels - 1]):
            self.add_module(f"dec_{i}", ConvBlock(ch, f, dtype, device, quant))
            ch = f
            if i < nb_levels - 1 - nb_upsample_skips:
                ch += skip_ch.pop()
        for j, f in enumerate(self.dec_nf[nb_levels - 1:]):
            self.add_module(f"final_{j}", ConvBlock(ch, f, dtype, device, quant))
            ch = f
        self.out_channels = ch

    def forward(self, x, impl=None, pool_tie="equal"):
        x = x.to(self.dtype)
        nb_levels = len(self.enc_nf) + 1
        fused_first = (self.nb_upsample_skips >= 1
                       and not needs_grad(x, *self.parameters()))
        skips = [x]
        for i in range(len(self.enc_nf)):
            block = getattr(self, f"enc_{i}")
            if i == 0 and fused_first:
                x = block.forward_pooled(x, impl=impl)
                skips.append(None)  # never popped; keeps pop order aligned
                continue
            x = block(x, impl=impl)
            skips.append(x)
            x = max_pool_2x(x, tie=pool_tie, impl=impl)
        for i in range(len(self.dec_nf[: nb_levels - 1])):
            x = getattr(self, f"dec_{i}")(x, impl=impl)
            if i < nb_levels - 1 - self.nb_upsample_skips:
                x = torch.cat([_upsample_nearest_2x(x), skips.pop()], dim=-1)
        for j in range(len(self.dec_nf[nb_levels - 1:])):
            x = getattr(self, f"final_{j}")(x, impl=impl)
        return x
