"""SynthMorph training: on-device synthesis, the Dice + Grad loss, Adam.

Counterpart of ``multimodal_registration_tpu/train/trainer.py``. One step:
augment the label maps (flips, zero borders), synthesise two images from
them (``synth/image_engine.py``), register them with ``VxmDense``, warp the
source labels once by the composed generator and model field, and take
``dice(map_2, pred) + 1 + Grad('l2', reg_param)``. The whole label-map bank
lives on the device and a step gathers its batch there.

The step is split where the random numbers end: :func:`draw_batch` draws
every random number of a batch from one generator, :func:`build_batch`
synthesises the images from them (:func:`synthesize` is both; no gradient
flows into it), :func:`loss_from_batch` is deterministic. The parity tests
hand :func:`loss_from_batch` the batch that the JAX package synthesised.

Data-parallel training (``Trainer(cfg, mesh=...)`` or ``num_devices`` > 1)
splits the batch over the ``data`` axis of a mesh (``parallel/mesh.py``),
one controller for all replicas, and keeps the JAX package's invariant: an
n-replica step equals the 1-device step on the same generator, maps and
parameters. The draws run on the first device in the 1-device order; each
replica builds its samples and scores them on its device, its loss weighted
by its share of the batch; the gradients are summed onto the first device in
replica order, clipped and applied there, and the parameters copied back to
the other devices before the next step.

Kernels on this path, per step at batch B on one device: K2 x11 (5 for the
generators' integration, 5 for the model's, 1 compose, each batched), K5 x6
(their backward; the generators' need none), K6 x2B+1 (two synthesis warps a
sample, and the loss's Dice sums through K6's Dice entry), K7 x1 (the Dice
loss's flow gradient through K7's Dice entry), K4 x4 (the pools of enc_0..enc_3). K1 and K3 are inference kernels: enc_0
runs unfused and ``moved`` is not computed.

Differences from the JAX trainer: checkpoints are the flat ``.npz``
(either package loads the other's) plus a ``torch.save`` of the optimizer
state, and the pool adjoint's tie rule is an argument (``pool_tie``), not an
environment switch.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from multimodal_registration_torch.device import full_fp32_convs
from multimodal_registration_torch.losses import grad_loss
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax, params_to_jax
from multimodal_registration_torch.ops.field import compose_fields_batch
from multimodal_registration_torch.ops.integrate import integrate_svf_batch
from multimodal_registration_torch.ops.pool import TIES
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_onehot_dice_batch
from multimodal_registration_torch.parallel.mesh import make_mesh, mesh_devices, replicate
from multimodal_registration_torch.synth.augment import maybe_zero_borders, random_flips
from multimodal_registration_torch.synth.image_engine import (
    ImageEngineConfig,
    payload_dtype,
    draw_engine_randoms,
    draw_svf_small,
    labels_to_image,
    labels_to_image_full,
    reduced_svf_grid,
)
from multimodal_registration_torch.train.config import TrainConfig
from multimodal_registration_torch.utils.profiling import span


def engine_config_from(cfg: TrainConfig) -> ImageEngineConfig:
    return ImageEngineConfig(
        num_labels=cfg.num_labels,
        vel_std=cfg.vel_std,
        vel_res=cfg.vel_res,
        bias_std=cfg.bias_std,
        bias_res=cfg.bias_res,
        blur_std=cfg.blur_std,
        gamma=cfg.gamma,
        svf_int_res=cfg.svf_int_res,
    )


def vxm_config_from(cfg: TrainConfig) -> VxmConfig:
    return VxmConfig(
        enc=tuple(cfg.enc),
        dec=tuple(cfg.dec),
        int_steps=cfg.int_steps,
        int_res=cfg.int_res,
        svf_res=cfg.svf_res,
        compute_dtype=cfg.compute_dtype,
    )


@torch.no_grad()
def draw_batch(gen: torch.Generator, src_lab: torch.Tensor, trg_lab: torch.Tensor,
               engine_cfg: ImageEngineConfig, cfg: TrainConfig, zero_borders: bool) -> dict:
    """Every random number of a batch, drawn from ``gen`` sample by sample:
    the augmented ``(B, X, Y, Z)`` label maps ``src`` and ``trg`` (flips,
    zero borders) and the two generators' draws ``r1``, ``r2`` (one dict a
    sample), on the maps' device."""
    B = src_lab.shape[0]
    in_shape = tuple(src_lab.shape[1:4])
    dev = src_lab.device
    s_aug, t_aug, r1, r2 = [], [], [], []
    for b in range(B):
        s, t = random_flips(gen, (src_lab[b], trg_lab[b]))
        if zero_borders:
            s = maybe_zero_borders(gen, s, cfg.zero_bord_scale, cfg.zero_bord_frac)
            t = maybe_zero_borders(gen, t, cfg.zero_bord_scale, cfg.zero_bord_frac)
        s_aug.append(s)
        t_aug.append(t)
        r1.append(draw_engine_randoms(gen, in_shape, engine_cfg, dev))
        r2.append(draw_engine_randoms(gen, in_shape, engine_cfg, dev))
    return {"src": s_aug, "trg": t_aug, "r1": r1, "r2": r2}


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def draws_of(draws: dict, rows: slice, device) -> dict:
    """The draws of samples ``rows``, copied to ``device``."""
    return {k: _to(vs[rows], device) for k, vs in draws.items()}


@torch.no_grad()
def build_batch(draws: dict, engine_cfg: ImageEngineConfig, impl=None) -> dict:
    """Synthesise the batch of :func:`draw_batch`'s draws: ``img1``,
    ``img2`` ``(B, X, Y, Z)``; ``raw1`` the augmented source labels (int32);
    ``phi1`` the source generator's full-res field and ``phi1s`` its
    reduced-grid field (or ``None``); ``map2`` the target's soft one-hot map
    ``(B, X, Y, Z, L)``. Both generators' SVFs are integrated in one batched
    scaling and squaring (2B fields)."""
    s_aug, t_aug, r1, r2 = draws["src"], draws["trg"], draws["r1"], draws["r2"]
    B = len(s_aug)
    in_shape = tuple(s_aug[0].shape[:3])
    ph1 = ph2 = [None] * B
    if reduced_svf_grid(in_shape, engine_cfg) is not None:
        svfs = torch.stack([draw_svf_small(r, in_shape, engine_cfg) for r in r1 + r2])
        phis = integrate_svf_batch(svfs, engine_cfg.int_steps, payload_dtype(engine_cfg),
                                   impl=impl)
        ph1, ph2 = phis[:B], phis[B:]

    cols = {k: [] for k in ("img1", "raw1", "phi1", "phi1s", "img2", "map2")}
    for b in range(B):
        img1, _, raw1, phi1, phi1s = labels_to_image_full(
            s_aug[b], engine_cfg, randoms=r1[b], phi_small_pre=ph1[b], impl=impl)
        img2, map2 = labels_to_image(
            t_aug[b], engine_cfg, randoms=r2[b], phi_small_pre=ph2[b], impl=impl)
        for k, v in zip(cols, (img1, raw1, phi1, phi1s, img2, map2)):
            cols[k].append(v)
    return {k: (None if v[0] is None else torch.stack(v)) for k, v in cols.items()}


def synthesize(gen: torch.Generator, src_lab: torch.Tensor, trg_lab: torch.Tensor,
               engine_cfg: ImageEngineConfig, cfg: TrainConfig, zero_borders: bool,
               impl=None) -> dict:
    """Augment ``(B, X, Y, Z)`` integer label maps and synthesise the batch
    (:func:`build_batch` of :func:`draw_batch`)."""
    return build_batch(draw_batch(gen, src_lab, trg_lab, engine_cfg, cfg, zero_borders),
                       engine_cfg, impl)


def _compose_plan(cfg: TrainConfig, vxm_cfg: VxmConfig, full_shape, phi_grid):
    """Which branches the loss takes for these shapes: ``(k, grad_on_warp)``.
    ``k`` is the integer ratio of the model's warp grid to the generator's
    reduced grid when the reduced compose applies, else ``None`` (full-res
    compose); ``grad_on_warp`` says that Grad penalises the int-res warp."""
    warp_grid = tuple(int(round(d / vxm_cfg.int_res)) for d in full_shape)
    k = None
    if (cfg.compose_res > 1 and phi_grid is not None
            and all(w % p == 0 for w, p in zip(warp_grid, phi_grid))):
        ratios = set(w // p for w, p in zip(warp_grid, phi_grid))
        if len(ratios) == 1:
            k = ratios.pop()
    grad_on_warp = (cfg.grad_res > 1
                    and warp_grid == tuple(s // cfg.grad_res for s in full_shape))
    return k, grad_on_warp


def loss_from_batch(model: VxmDense, batch: dict, engine_cfg: ImageEngineConfig,
                    cfg: TrainConfig, use_zeropad: bool, impl=None,
                    pool_tie: str = "equal"):
    """Register the batch's images and score the warped labels: ``(loss,
    aux)`` with ``aux`` holding ``dice_loss``, ``grad_loss`` and ``loss``."""
    img1, img2, phi1s = batch["img1"], batch["img2"], batch["phi1s"]
    full_shape = tuple(img1.shape[1:4])
    phi_grid = tuple(phi1s.shape[1:4]) if phi1s is not None else None
    k, grad_on_warp = _compose_plan(cfg, model.cfg, full_shape, phi_grid)
    out = model(img1[..., None], img2[..., None], impl=impl, with_moved=False,
                with_fullres=(k is None or not grad_on_warp), pool_tie=pool_tie)
    warp_grid = tuple(out["warp"].shape[1:4])
    if k is not None:
        # reduced compose: the generator's small-grid field (brought to the
        # warp grid when it is coarser) composed with the model's int-res
        # warp, and the result upsampled once
        if k > 1:
            phi1s = torch.stack([rescale_field(v, float(k), out_shape=warp_grid)
                                 for v in phi1s])
        total_half = compose_fields_batch(phi1s, out["warp"], impl=impl)
        f = tuple(o / h for o, h in zip(full_shape, total_half.shape[1:4]))
        total_field = torch.stack([rescale_field(v, f, out_shape=full_shape)
                                   for v in total_half])
    else:
        # full-res compose: one interpolation of the raw labels by the
        # composed generator + model field; gathered values in the compose
        # payload type, the sum in float32
        phi1 = batch["phi1"]
        if cfg.compose_payload_dtype:
            phi1 = phi1.to(getattr(torch, cfg.compose_payload_dtype))
        total_field = compose_fields_batch(phi1, out["flow_fullres"], impl=impl).float()
    # the Dice of the warped source labels, fused: neither the warped one-hot
    # nor its cotangent is formed (impl="plain": the dense composition)
    d = warp_onehot_dice_batch(batch["raw1"], total_field, batch["map2"], engine_cfg.num_labels,
                               zeropad=use_zeropad, impl=impl)
    g = grad_loss(out["warp"] if grad_on_warp else out["flow_fullres"], "l2", cfg.reg_param)
    loss = d + 1.0 + g
    return loss, {"dice_loss": d.detach(), "grad_loss": g.detach(), "loss": loss.detach()}


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place on the ``.grad`` of ``params``:
    unchanged while the global norm is below ``max_norm``, else scaled to it
    (``g / norm * max_norm``; ``clip_grad_norm_`` divides by ``norm + 1e-6``,
    which is another function). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm


def init_like_flax_(model: VxmDense, seed: int) -> None:
    """Initialise ``model`` as the JAX package's ``model.init`` does: conv
    kernels LeCun-normal (truncated at 2 std, variance ``1 / fan_in``), biases
    zero, the flow head normal with std 1e-5. Drawn on the CPU from ``seed``,
    so the weights do not depend on the device."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, nn.Conv3d):
                continue
            w = torch.empty(mod.weight.shape)
            if name == "flow":
                w.normal_(0.0, 1e-5, generator=gen)
            else:
                fan_in = mod.weight.shape[1] * 27
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            mod.weight.copy_(w)
            mod.bias.zero_()


class Trainer:
    """Owns the mesh, the model (on the mesh's first device, with a copy on
    each other device of its ``data`` axis), the optimizer, the steps and the
    checkpoints. Without a ``mesh`` it makes one of ``cfg.num_devices`` of the
    devices ``device`` offers (``parallel/mesh.py::mesh_devices``: every card
    for ``cuda``, a list such as ``"cuda:0,cuda:0"``, the CPU repeated);
    ``num_devices`` None takes the largest count of them that divides the
    batch (1 on the CPU)."""

    def __init__(self, cfg: TrainConfig, device=None, pool_tie: str = "equal", mesh=None):
        if pool_tie not in TIES:
            raise ValueError(f"pool_tie must be one of {TIES}, got {pool_tie!r}")
        if mesh is None:
            n = cfg.num_devices
            if n is None:
                avail = len(mesh_devices(device))
                n = max(k for k in range(1, avail + 1) if cfg.batch_size % k == 0)
            devs = mesh_devices(device, n)
            if n > len(devs):
                raise ValueError(f"num_devices={n} needs {n} devices, have {len(devs)}")
            mesh = make_mesh(n, devices=devs)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.home
        self.pool_tie = pool_tie
        self.vxm_cfg = vxm_config_from(cfg)
        self.engine_cfg = engine_config_from(cfg)
        self.model = VxmDense(self.vxm_cfg, device=self.device)
        self.replicas = [mesh.devices[r, 0] for r in range(mesh.shape["data"])]
        self.models = replicate(self.model, self.replicas)
        self.init_state()

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int | None = None) -> dict:
        """Fresh weights (from ``seed``, default ``cfg.seed``) and a fresh
        Adam; returns the model's state dict."""
        init_like_flax_(self.model, self.cfg.seed if seed is None else seed)
        self._new_optimizer()
        return self.model.state_dict()

    def _new_optimizer(self) -> None:
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def put_batch(self, src: np.ndarray, trg: np.ndarray):
        return (torch.as_tensor(np.ascontiguousarray(src), device=self.device),
                torch.as_tensor(np.ascontiguousarray(trg), device=self.device))

    def put_bank(self, maps: np.ndarray) -> torch.Tensor:
        """Upload the whole label-map bank ``(N, X, Y, Z)`` uint8."""
        return torch.as_tensor(np.ascontiguousarray(maps), device=self.device)

    def put_indices(self, src_idx: np.ndarray, trg_idx: np.ndarray):
        return (torch.as_tensor(np.asarray(src_idx, np.int64), device=self.device),
                torch.as_tensor(np.asarray(trg_idx, np.int64), device=self.device))

    # -- steps ---------------------------------------------------------------
    @torch.no_grad()
    def _sync_replicas(self) -> None:
        """Copy the first device's parameters to the other devices' models."""
        for m in self.models.values():
            if m is not self.model:
                for p, q in zip(m.parameters(), self.model.parameters()):
                    p.copy_(q)

    @torch.no_grad()
    def _reduce_grads(self, model: VxmDense) -> None:
        """Add ``model``'s gradients into the first device's and clear them."""
        if model is self.model:
            return
        for p, q in zip(model.parameters(), self.model.parameters()):
            if p.grad is not None:
                g = p.grad.to(self.device)
                q.grad = g if q.grad is None else q.grad.add_(g)
                p.grad = None

    def shares(self, gen, src, trg, zero_borders: bool):
        """Draw the batch's randoms on the first device, then yield each
        replica's ``(model, batch, share)``: its samples built on its device
        and their share of the batch (the whole batch on the first device
        when it does not divide by the replicas)."""
        B = src.shape[0]
        rows = self.replicas if B % len(self.replicas) == 0 else [self.device]
        b = B // len(rows)
        with span("train.draw"):
            draws = draw_batch(gen, src, trg, self.engine_cfg, self.cfg, zero_borders)
        parts = [draws_of(draws, slice(r * b, (r + 1) * b), dev) for r, dev in enumerate(rows)]
        del draws  # each share's draws are freed once its batch is built
        for dev in rows:
            with span("train.build"):
                batch = build_batch(parts[0], self.engine_cfg)
            # the share's draws are freed here, past the span; the caller alone
            # holds the batch, so that it can free it before the backward
            parts[0] = batch
            del batch
            yield self.models[dev], parts.pop(0), b / B

    def losses(self, shares, backward: bool) -> dict:
        """Score each ``(model, batch, share)`` of ``shares``; with
        ``backward`` each loss, weighted by its share, back-propagates and
        its gradients are summed onto the first device in replica order.
        Returns the aux scalars, the weighted sums of the replicas'."""
        self._sync_replicas()
        use_zeropad = self.cfg.zero_borders_maps or self.cfg.zero_borders_maps_val
        aux = None
        for model, batch, share in shares:
            with span("train.loss"):
                loss, aux_r = loss_from_batch(model, batch, self.engine_cfg, self.cfg,
                                              use_zeropad, pool_tie=self.pool_tie)
            del batch  # what the backward needs, its graph holds
            if backward:
                scaled = loss * share
                # the float32 flow head's cuDNN backward runs here, outside
                # the forward's context: keep TF32 off for it too
                with full_fp32_convs(), span("train.backward"):
                    scaled.backward()
                self._reduce_grads(model)
            aux_r = {k: (v * share).to(self.device) for k, v in aux_r.items()}
            aux = aux_r if aux is None else {k: aux[k] + aux_r[k] for k in aux}
        return aux

    def train_step(self, gen: torch.Generator, src: torch.Tensor, trg: torch.Tensor) -> dict:
        """One optimizer step on the label maps ``src``, ``trg`` ``(B, X, Y,
        Z)`` on the first device; returns the aux scalars (tensors there)."""
        with span("train.step"):
            for m in self.models.values():
                m.train()
            self.optimizer.zero_grad(set_to_none=True)
            aux = self.losses(self.shares(gen, src, trg, self.cfg.zero_borders_maps),
                              backward=True)
            if self.cfg.grad_clip_norm and self.cfg.grad_clip_norm > 0:
                with span("train.clip"):
                    clip_by_global_norm_(list(self.model.parameters()), self.cfg.grad_clip_norm)
            with span("train.adam"):
                self.optimizer.step()
            return aux

    @torch.no_grad()
    def val_step(self, gen: torch.Generator, src: torch.Tensor, trg: torch.Tensor) -> dict:
        with span("train.val"):
            for m in self.models.values():
                m.eval()
            return self.losses(self.shares(gen, src, trg, self.cfg.zero_borders_maps_val),
                               backward=False)

    def train_step_banked(self, gen, bank, src_idx, trg_idx) -> dict:
        """:meth:`train_step` on ``bank[src_idx]``, ``bank[trg_idx]``, gathered
        on the device."""
        return self.train_step(gen, bank[src_idx], bank[trg_idx])

    def val_step_banked(self, gen, bank, src_idx, trg_idx) -> dict:
        return self.val_step(gen, bank[src_idx], bank[trg_idx])

    # -- checkpoints ---------------------------------------------------------
    def save_checkpoint(self, path: str, epoch: int = 0) -> None:
        """``path + '.npz'``: the weights in the JAX package's flat key
        format; ``path + '.opt.pt'``: the optimizer state and the epoch."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path + ".npz", **params_to_jax(self.model.state_dict()))
        torch.save({"optimizer": self.optimizer.state_dict(), "epoch": int(epoch)},
                   path + ".opt.pt")

    def load_checkpoint(self, path: str, with_opt: bool = False) -> int:
        """Load weights (and, with ``with_opt``, the optimizer state when a
        ``.opt.pt`` lies beside them) into the trainer; returns the epoch.
        ``path`` is a checkpoint stem or its ``.npz``, or a Keras VoxelMorph
        ``.h5`` (weights only, epoch 0)."""
        if path.endswith((".h5", ".hdf5")):
            from multimodal_registration_torch.models.h5_import import import_keras_vxm_h5

            self.model.load_state_dict(import_keras_vxm_h5(path, self.vxm_cfg))
            self._new_optimizer()
            return 0
        stem = path[:-4] if path.endswith(".npz") else path
        if not os.path.exists(stem + ".npz"):
            if os.path.isdir(path):
                raise NotImplementedError(
                    "Orbax checkpoint directories are not read by the port (ROADMAP "
                    "queue 1 item 9c): use the flat .npz written beside them")
            raise FileNotFoundError(stem + ".npz")
        with np.load(stem + ".npz") as z:
            state = params_from_jax(dict(z), self.vxm_cfg)
        self.model.load_state_dict(state)
        epoch = 0
        self._new_optimizer()
        if os.path.exists(stem + ".opt.pt"):
            extra = torch.load(stem + ".opt.pt", map_location=self.device, weights_only=True)
            epoch = int(extra["epoch"])
            if with_opt:
                self.optimizer.load_state_dict(extra["optimizer"])
        return epoch
