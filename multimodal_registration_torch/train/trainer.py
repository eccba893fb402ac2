"""SynthMorph training: on-device synthesis, the Dice + Grad loss, Adam.

Counterpart of ``multimodal_registration_tpu/train/trainer.py``. One step:
augment the label maps (flips, zero borders), synthesise two images from
them (``synth/image_engine.py``), register them with ``VxmDense``, warp the
source labels once by the composed generator and model field, and take
``dice(map_2, pred) + 1 + Grad('l2', reg_param)``. The whole label-map bank
lives on the device and a step gathers its batch there.

The step is split where the random numbers end: :func:`synthesize` draws
and builds a batch (no gradient flows into it), :func:`loss_from_batch` is
deterministic. The parity tests hand :func:`loss_from_batch` the batch that
the JAX package synthesised.

Kernels on this path, per step at batch B: K2 x11 (5 for the generators'
integration, 5 for the model's, 1 compose), K5 x6 (their backward; the
generators' need none), K6 x3B (two synthesis warps and the loss's), K7 x1,
K4 x4 (the pools of enc_0..enc_3). K1 and K3 are inference kernels: enc_0
runs unfused and ``moved`` is not computed.

Differences from the JAX trainer: one device only (``num_devices`` > 1 is
not ported), checkpoints are the flat ``.npz`` (either package loads the
other's) plus a ``torch.save`` of the optimizer state, and the pool
adjoint's tie rule is an argument (``pool_tie``), not an environment switch.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from multimodal_registration_torch.device import full_fp32_convs, resolve_device
from multimodal_registration_torch.losses import dice_loss, dice_loss_zeropad, grad_loss
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax, params_to_jax
from multimodal_registration_torch.ops.field import compose_fields_batch
from multimodal_registration_torch.ops.integrate import integrate_svf_batch
from multimodal_registration_torch.ops.pool import TIES
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp_onehot_batch
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
def synthesize(gen: torch.Generator, src_lab: torch.Tensor, trg_lab: torch.Tensor,
               engine_cfg: ImageEngineConfig, cfg: TrainConfig, zero_borders: bool,
               impl=None) -> dict:
    """Augment ``(B, X, Y, Z)`` integer label maps and synthesise the batch:
    ``img1``, ``img2`` ``(B, X, Y, Z)``; ``raw1`` the augmented source labels
    (int32); ``phi1`` the source generator's full-res field and ``phi1s`` its
    reduced-grid field (or ``None``); ``map2`` the target's soft one-hot map
    ``(B, X, Y, Z, L)``. Both generators' SVFs are integrated in one batched
    scaling and squaring (2B fields)."""
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
    pred = warp_onehot_batch(batch["raw1"], total_field, engine_cfg.num_labels, impl=impl)
    d = (dice_loss_zeropad if use_zeropad else dice_loss)(batch["map2"], pred)
    g = grad_loss(out["warp"] if grad_on_warp else out["flow_fullres"], "l2", cfg.reg_param)
    loss = d + 1.0 + g
    return loss, {"dice_loss": d.detach(), "grad_loss": g.detach(), "loss": loss.detach()}


def make_loss_fn(model: VxmDense, engine_cfg: ImageEngineConfig, cfg: TrainConfig,
                 zero_borders: bool, pool_tie: str = "equal"):
    """The per-batch loss ``loss_fn(gen, src_lab, trg_lab) -> (loss, aux)``:
    augment, synthesise, register, Dice + Grad."""
    use_zeropad = cfg.zero_borders_maps or cfg.zero_borders_maps_val

    def loss_fn(gen, src_lab, trg_lab):
        batch = synthesize(gen, src_lab, trg_lab, engine_cfg, cfg, zero_borders)
        return loss_from_batch(model, batch, engine_cfg, cfg, use_zeropad, pool_tie=pool_tie)

    return loss_fn


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
    """Owns the model, the optimizer, the steps and the checkpoints."""

    def __init__(self, cfg: TrainConfig, device=None, pool_tie: str = "equal"):
        if cfg.num_devices is not None and cfg.num_devices > 1:
            raise NotImplementedError(
                "num_devices > 1 (data-parallel training) is not ported yet "
                "(ROADMAP queue 1 item 15)")
        if pool_tie not in TIES:
            raise ValueError(f"pool_tie must be one of {TIES}, got {pool_tie!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pool_tie = pool_tie
        self.vxm_cfg = vxm_config_from(cfg)
        self.engine_cfg = engine_config_from(cfg)
        self.model = VxmDense(self.vxm_cfg, device=self.device)
        self._loss_tr = make_loss_fn(self.model, self.engine_cfg, cfg, cfg.zero_borders_maps,
                                     pool_tie)
        self._loss_val = make_loss_fn(self.model, self.engine_cfg, cfg,
                                      cfg.zero_borders_maps_val, pool_tie)
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
    def train_step(self, gen: torch.Generator, src: torch.Tensor, trg: torch.Tensor) -> dict:
        """One optimizer step on the label maps ``src``, ``trg`` ``(B, X, Y,
        Z)``; returns the aux scalars (tensors on the device)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self._loss_tr(gen, src, trg)
        # the float32 flow head's cuDNN backward runs here, outside the
        # forward's context: keep TF32 off for it too
        with full_fp32_convs():
            loss.backward()
        if self.cfg.grad_clip_norm and self.cfg.grad_clip_norm > 0:
            clip_by_global_norm_(list(self.model.parameters()), self.cfg.grad_clip_norm)
        self.optimizer.step()
        return aux

    @torch.no_grad()
    def val_step(self, gen: torch.Generator, src: torch.Tensor, trg: torch.Tensor) -> dict:
        self.model.eval()
        return self._loss_val(gen, src, trg)[1]

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
