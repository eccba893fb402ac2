"""The registration forward with each volume's X axis split over devices.

The port's counterpart of what XLA's partitioner does for the JAX package's
``ShardedRegistrar`` (``multimodal_registration_tpu/infer/sharded.py``): the
U-Net and the flow head run on X slabs, one per device of a ``space`` row of
the mesh, and exchange halos; the rest of the forward runs on the row's
first device on the whole field.

  * Slabs are ``X / space`` wide, a multiple of 16, so every 2x pool window
    of the four levels lies inside one slab: the max-pool, the nearest 2x
    upsample and the skip concatenations are local to a slab.
  * A 3³ conv runs on its slab with one X plane of each neighbour copied in
    (zeros at the volume's two ends, which is SAME padding) and its output
    is cropped by one plane at each end. This holds for cuDNN's convs, for
    the int8 conv K8 and for the float32 flow head alike.
  * enc_0 on K1 (conv, LeakyReLU and 2x max-pool fused) takes two planes:
    the slab's first plane has an even X, so with two planes in front the
    pooled pairs stay aligned, and cropping one pooled cell at each end
    leaves exactly the slab's pooled output.
  * The 3-channel head output is gathered onto the row's first device,
    where :meth:`VxmDense.tail` integrates it (K2) and warps (K3).

Each device holds its own copy of the model; two slabs on one device share
it. int8 calibration may run over slabs: the input of every quantizable conv
on a slab plus its halo covers the whole tensor, and the zeros add nothing
to a maximum of ``|x|``, so the maxima over slabs are the whole volume's.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_registration_torch.ops.pool import max_pool_2x
from multimodal_registration_torch.ops.up_cat import upsample_cat
from multimodal_registration_torch.parallel.mesh import gather, split_slabs


def with_halo(slabs: list, h: int) -> list:
    """Each ``(B, w, Y, Z, C)`` slab with ``h`` X planes of each neighbour
    copied onto its device, zeros beyond the volume's ends: ``(B, w + 2h,
    Y, Z, C)``."""
    out = []
    for k, s in enumerate(slabs):
        zeros = s.new_zeros((s.shape[0], h, *s.shape[2:]))
        left = slabs[k - 1][:, -h:].to(s.device) if k > 0 else zeros
        right = slabs[k + 1][:, :h].to(s.device) if k + 1 < len(slabs) else zeros
        out.append(torch.cat([left, s, right], dim=1))
    return out


class Slabs:
    """The steps of :meth:`Unet.walk` on a list of X slabs, slab ``k``'s
    convs on ``unets[k]``, the U-Net copy of its device."""

    def __init__(self, unets: list, impl=None, pool_tie: str = "equal"):
        self.unets, self.impl, self.pool_tie = unets, impl, pool_tie

    def conv(self, name, xs):
        return [getattr(u, name)(p, impl=self.impl)[:, 1:-1]
                for u, p in zip(self.unets, with_halo(xs, 1))]

    def conv_pooled(self, name, xs):
        return [getattr(u, name).forward_pooled(p, impl=self.impl)[:, 1:-1]
                for u, p in zip(self.unets, with_halo(xs, 2))]

    def pool(self, xs):
        return [max_pool_2x(x, tie=self.pool_tie, impl=self.impl) for x in xs]

    def up_cat(self, xs, skips):
        return [upsample_cat(x, s, impl=self.impl) for x, s in zip(xs, skips)]


def unet_slabs(models: dict, devices, moving, fixed, impl=None) -> list:
    """The U-Net's features of ``concat(moving, fixed)`` ``(B, X, Y, Z, 1)``
    as X slabs, slab ``k`` on ``devices[k]``; ``models`` is ``{device:
    VxmDense}``. Inference only."""
    unet = models[devices[0]].unet
    x = torch.cat([moving, fixed], dim=-1).to(unet.dtype)
    layers = Slabs([models[d].unet for d in devices], impl)
    return unet.walk(split_slabs(x, devices), layers, unet.nb_upsample_skips >= 1)


def forward_slabs(models: dict, devices, moving, fixed, impl=None,
                  with_moved: bool = True) -> dict:
    """:meth:`VxmDense.forward` of ``moving``, ``fixed`` ``(B, X, Y, Z, 1)``
    on the first of ``devices``, its U-Net and flow head on X slabs over
    ``devices``; the outputs on the first device (``with_moved=False``:
    neither the moved image nor the full-res field)."""
    home = devices[0]
    feat = unet_slabs(models, devices, moving, fixed, impl)
    svf = gather([models[d].flow_head(p, impl=impl)[:, 1:-1]
                  for d, p in zip(devices, with_halo(feat, 1))], home, dim=1)
    return models[home].tail(moving, svf, impl=impl, with_moved=with_moved,
                             with_fullres=with_moved)


def calibrate_slabs(models: dict, rows, margin: float = 1.25, impl=None) -> dict:
    """int8 activation scales from a full-precision pass of the U-Net over
    slabs, as ``models/quantize.py::calibrate_scales`` gives them for the
    whole volumes: each quantizable conv's input ``max|x|`` times
    ``margin``. ``rows``: ``(devices, moving, fixed)`` of each data row."""
    replicas = list(models.values())
    for m in replicas:
        m.quant_calibrate = True
    try:
        with torch.inference_mode():
            for devices, mov, fx in rows:
                unet_slabs(models, devices, mov, fx, impl)
        recorded = [m.recorded_scales() for m in replicas]
    finally:
        for m in replicas:
            m.quant_calibrate = False
    keys = dict.fromkeys(k for r in recorded for k in r)
    return {k: np.float32(max(r[k] for r in recorded if k in r)) * np.float32(margin)
            for k in keys}
