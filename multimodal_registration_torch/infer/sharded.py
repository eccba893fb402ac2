"""The registration forward over several devices, and the registrar factory
of the inference entry points.

Counterpart of ``multimodal_registration_tpu/infer/sharded.py``: a
``(data, space)`` mesh (``parallel/mesh.py``) takes the batch over ``data``
and each volume's X axis over ``space``. Each data row runs the U-Net and
the flow head on X slabs with halo exchanges and the rest of the forward on
its first device (``parallel/spatial.py``); the outputs come back to the
mesh's first device, where the caller's pre- and postprocessing run.
"""

from __future__ import annotations

import warnings

import torch

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.register import (
    Registrar, on_device, persist_quant_sidecar, vxm_config_from)
from multimodal_registration_torch.models.vxm_dense import VxmDense
from multimodal_registration_torch.parallel.mesh import (
    Mesh, first_device, gather, make_mesh, mesh_devices, replicate, split_rows)
from multimodal_registration_torch.parallel.spatial import calibrate_slabs, forward_slabs


class ShardedRegistrar:
    """Registration forward over a ``(data, space)`` mesh, with the
    :class:`Registrar`'s interface (``device``, ``impl``,
    ``predict_tensors``, ``register_tensors``, ``predict``); ``device`` is
    the mesh's first.

    Accepts any batch size: it is padded with zeros up to a multiple of the
    ``data`` axis and the pad is cropped from the outputs. A chunk holds
    ``data * max(1, max_batch // space)`` pairs, the last one zero-padded.
    Volumes whose X dim is not divisible by ``space * 16`` fall back to the
    single-device :class:`Registrar` with a warning (every slab must hold
    whole pool windows of the four levels). int8 scales: ``quant_scales``,
    or calibrated over the slabs of the first chunk and written to
    ``quant_sidecar``."""

    def __init__(self, cfg: InferenceConfig, params: dict, mesh: Mesh, max_batch: int = 4,
                 svf_smooth_sigma: float | None = None, quant_scales=None,
                 quant_sidecar: str | None = None, impl=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.home
        self.max_batch = max_batch
        self.impl = impl
        self.params = params
        self._svf_smooth_sigma = svf_smooth_sigma
        self._fallback = None
        self.vxm_cfg = vxm_config_from(cfg, svf_smooth_sigma)
        home = VxmDense(self.vxm_cfg, device=self.device).eval()
        home.load_state_dict(params)
        self.models = replicate(home, mesh.distinct())
        self.quant_scales = quant_scales
        self.quant_sidecar = quant_sidecar
        if self.vxm_cfg.quantize and quant_scales is not None:
            self._set_scales(quant_scales)
        self.tile_counts = {"tiles": 0, "slots": 0}

    # the tiles of use_subvol go through the mesh as any batch does
    register_tensors = Registrar.register_tensors

    def _chunk(self, batch: int) -> int:
        """Pairs a chunk takes when ``batch`` pairs are predicted: ``data *
        max(1, max_batch // space)``, 1/space as many rows per forward, as
        the JAX registrar bounds its activations."""
        space, data = self.mesh.shape["space"], self.mesh.shape["data"]
        chunk = data * max(1, self.max_batch // max(1, space))
        return min(chunk, max(data, batch + (-batch) % data))

    def _set_scales(self, scales) -> None:
        for m in self.models.values():
            m.set_quant_scales(scales)

    def _rows(self, m, f):
        """``(devices, moving, fixed)`` of each data row of a chunk, the
        inputs ``(b, X, Y, Z, 1)`` on the row's first device."""
        return [(list(self.mesh.devices[r]), mr[..., None], fr[..., None])
                for r, (mr, fr) in enumerate(zip(split_rows(m, self.mesh),
                                                 split_rows(f, self.mesh)))]

    def _ensure_scales(self, rows) -> None:
        if not self.vxm_cfg.quantize or self.quant_scales is not None:
            return
        self.quant_scales = calibrate_slabs(self.models, rows, impl=self.impl)
        self._set_scales(self.quant_scales)
        persist_quant_sidecar(self.quant_sidecar, self.quant_scales)

    def _single_device(self) -> Registrar:
        if self._fallback is None:
            self._fallback = Registrar(
                self.cfg, self.params, max_batch=self.max_batch, device=self.device,
                svf_smooth_sigma=self._svf_smooth_sigma, impl=self.impl,
                quant_scales=self.quant_scales, quant_sidecar=self.quant_sidecar)
        return self._fallback

    @torch.inference_mode()
    def predict_tensors(self, mov, fx, with_moved: bool = True, strict: bool = False):
        """Batched predict on ``(B, X, Y, Z)`` arrays or tensors -> ``(moved,
        warp)`` on :attr:`device`, as :meth:`Registrar.predict_tensors`. An X
        dim not divisible by ``space * 16`` falls back to one device (raises
        instead when ``strict``)."""
        space = self.mesh.shape["space"]
        mov, fx = on_device(mov, self.device), on_device(fx, self.device)
        if mov.shape[1] % (space * 16):
            msg = (f"volume X dim {mov.shape[1]} not divisible by space axis ({space}) x 16")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg + " — falling back to single-device forward")
            return self._single_device().predict_tensors(mov, fx, with_moved=with_moved)
        B = mov.shape[0]
        chunk = self._chunk(B)
        moved_parts, warp_parts = [], []
        for s in range(0, B, chunk):
            m, f = mov[s: s + chunk], fx[s: s + chunk]
            n = m.shape[0]
            if n < chunk:  # every chunk has the same shape
                pad = torch.zeros((chunk - n, *m.shape[1:]), device=self.device)
                m, f = torch.cat([m, pad]), torch.cat([f, pad])
            rows = self._rows(m, f)
            self._ensure_scales(rows)
            outs = [forward_slabs(self.models, devs, mr, fr, impl=self.impl,
                                  with_moved=with_moved) for devs, mr, fr in rows]
            if with_moved:
                moved_parts.append(gather([o["moved"] for o in outs], self.device)[:n, ..., 0])
            warp_parts.append(gather([o["warp"] for o in outs], self.device)[:n])
        return (torch.cat(moved_parts) if with_moved else None), torch.cat(warp_parts)

    def predict(self, mov, fx, strict: bool = False):
        """:meth:`predict_tensors` as numpy arrays on the host."""
        moved, warp = self.predict_tensors(mov, fx, strict=strict)
        return moved.cpu().numpy(), warp.cpu().numpy()


def make_registrar(cfg: InferenceConfig, params, max_batch: int = 4,
                   svf_smooth_sigma: float | None = None, quant_scales=None,
                   quant_sidecar: str | None = None, device=None):
    """The registrar the inference config asks for.

    ``cfg.sharding`` empty (or ``{"data": 1, "space": 1}``): a
    :class:`Registrar` on ``device``; anything larger: a
    :class:`ShardedRegistrar` over a ``(data, space)`` mesh of the devices
    ``device`` offers (``parallel/mesh.py::mesh_devices``: every card for
    ``cuda``, an explicit list such as ``"cuda:0,cuda:0"``, or the CPU
    repeated). Raises if the layout needs more devices than there are."""
    data = int(cfg.sharding.get("data", 1) or 1)
    space = int(cfg.sharding.get("space", 1) or 1)
    kw = dict(max_batch=max_batch, svf_smooth_sigma=svf_smooth_sigma,
              quant_scales=quant_scales, quant_sidecar=quant_sidecar)
    if data * space <= 1:
        return Registrar(cfg, params, device=first_device(device), **kw)
    devs = mesh_devices(device, data * space)
    if data * space > len(devs):
        raise ValueError(f"sharding {{data: {data}, space: {space}}} needs {data * space} "
                         f"devices, have {len(devs)}")
    return ShardedRegistrar(cfg, params, make_mesh(data * space, space=space, devices=devs),
                            **kw)
