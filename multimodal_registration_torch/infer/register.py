"""Single-model registration flow: preprocess -> model -> field assembly ->
NIfTI postprocess.

Counterpart of ``multimodal_registration_tpu/infer/register.py``, with the
same output-file names (``*_proc``, ``*_proc_reg_to_<CONTRAST>``,
``*_proc_field_to_<CONTRAST>`` with NIfTI intent 1007, and the moved image
and field on the original moving grid), the same RAI export of the field and
the same ``timings`` keys. With ``use_subvol`` the tiles go through the
model in chunks of ``max_batch`` and their fields are blended on the device
(:mod:`infer.blend`). Everything runs on ``cuda`` unless the ``Registrar``
was built with ``device="cpu"``; a ``Registrar`` built with
``impl="plain"`` runs every kernel's plain version instead (the comparison
of ``chip_smoke.py``). With ``quantize: "int8"`` the registrar takes its
activation scales from ``quant_scales`` or calibrates them on the first
chunk it predicts, and writes them to ``quant_sidecar`` if given.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.infer.blend import blend_subvol_fields
from multimodal_registration_torch.infer.config import InferenceConfig, check_supported
from multimodal_registration_torch.infer.preprocess import preprocess
from multimodal_registration_torch.models import quantize as qmod
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.ops.resample import affine_resample
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp as device_warp
from multimodal_registration_torch.utils import nifti


def vxm_config_from(cfg: InferenceConfig, svf_smooth_sigma: float | None = None) -> VxmConfig:
    """The model config an :class:`InferenceConfig` maps to;
    ``svf_smooth_sigma`` overrides the config's (the cascade's first step)."""
    return VxmConfig(
        enc=tuple(cfg.enc),
        dec=tuple(cfg.dec),
        int_steps=cfg.int_steps,
        int_res=cfg.int_res,
        svf_res=cfg.svf_res,
        compute_dtype=cfg.compute_dtype,
        svf_smooth_sigma=float(
            (cfg.svf_smooth_sigma if svf_smooth_sigma is None else svf_smooth_sigma) or 0.0),
        quantize=str(cfg.quantize or ""),
    )


def persist_quant_sidecar(path: str, quant) -> bool:
    """Best-effort write of lazily calibrated int8 scales to the checkpoint's
    ``<model>.quant.json``, so the calibration forward is paid once per
    checkpoint, not once per process. Never raises: a read-only checkpoint
    directory only costs a calibration in the next process."""
    if not path or not quant:
        return False
    try:
        qmod.save_scales(path, quant)
        return True
    except OSError as e:
        warnings.warn(f"could not persist int8 scales to {path}: {e}")
        return False


def on_device(x, dev) -> torch.Tensor:
    """``x`` (array or tensor) as float32 on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


class Registrar:
    """Holds the model on its device. Batches larger than ``max_batch`` (the
    tiles of a subject) run in chunks of ``max_batch`` pairs, the last one
    zero-padded, so every call sees the same shapes and activation memory
    stays bounded. ``svf_smooth_sigma`` overrides the config's (the
    cascade's first model); ``impl`` goes to every kernel wrapper the
    registration runs (``None``: the kernels on the card, ``"plain"``:
    their plain versions). int8 scales: ``quant_scales`` (flat, as
    ``models/quantize.py::load_scales`` gives them) or, when None, calibrated
    on the first chunk predicted (one full-precision forward; every output
    comes from the int8 path) and written to ``quant_sidecar``."""

    def __init__(self, cfg: InferenceConfig, params: dict, max_batch: int = 4,
                 device=None, svf_smooth_sigma: float | None = None, impl=None,
                 quant_scales=None, quant_sidecar: str | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vxm_cfg = vxm_config_from(cfg, svf_smooth_sigma)
        self.model = VxmDense(self.vxm_cfg, device=self.device).eval()
        self.model.load_state_dict(params)
        self.max_batch = max_batch
        self.impl = impl
        self.quant_scales = quant_scales
        self.quant_sidecar = quant_sidecar
        if self.vxm_cfg.quantize and quant_scales is not None:
            self.model.set_quant_scales(quant_scales)

    def _ensure_scales(self, m, f):
        if not self.vxm_cfg.quantize or self.quant_scales is not None:
            return
        self.quant_scales = qmod.calibrate_scales(self.vxm_cfg, self.model,
                                                  [(m[..., None], f[..., None])], impl=self.impl)
        self.model.set_quant_scales(self.quant_scales)
        persist_quant_sidecar(self.quant_sidecar, self.quant_scales)

    @torch.inference_mode()
    def predict_tensors(self, mov, fx):
        """Batched predict on ``(B, X, Y, Z)`` arrays or tensors -> ``(moved,
        warp)`` on the device: ``(B, X, Y, Z)`` and the int-res field ``(B,
        x, y, z, 3)``."""
        mov, fx = on_device(mov, self.device), on_device(fx, self.device)
        B = mov.shape[0]
        chunk = min(self.max_batch, B)
        moved_parts, warp_parts = [], []
        for s in range(0, B, chunk):
            m, f = mov[s: s + chunk], fx[s: s + chunk]
            n = m.shape[0]
            if n < chunk:
                pad = torch.zeros((chunk - n, *m.shape[1:]), device=self.device)
                m, f = torch.cat([m, pad]), torch.cat([f, pad])
            self._ensure_scales(m, f)
            out = self.model(m[..., None], f[..., None], impl=self.impl)
            moved_parts.append(out["moved"][:n, ..., 0])
            warp_parts.append(out["warp"][:n])
        return torch.cat(moved_parts), torch.cat(warp_parts)

    def predict(self, mov, fx):
        """:meth:`predict_tensors` as numpy arrays on the host."""
        moved, warp = self.predict_tensors(mov, fx)
        return moved.cpu().numpy(), warp.cpu().numpy()


@torch.inference_mode()
def apply_warp(vol, field, interp: str, rescale: int = 1, device=None,
               impl=None) -> np.ndarray:
    """``vxm.networks.Transform(rescale=...)`` parity: upsample the field by
    ``rescale`` (scaling vectors), then warp. ``vol`` and ``field`` are
    arrays or tensors; the result is on the host."""
    dev = resolve_device(device)
    v, f = on_device(vol, dev), on_device(field, dev)
    if rescale != 1:
        f = rescale_field(f, int(rescale), out_shape=tuple(v.shape[:3]))
    return device_warp(v, f, interp=interp, impl=impl).cpu().numpy()


def _upsample2x_host(v: np.ndarray) -> np.ndarray:
    """Numpy twin of the corner-aligned 2x upsample (``ops/resize.py``) over
    the three spatial axes of an ``(X, Y, Z, C)`` field."""
    for ax in (2, 1, 0):
        nxt = np.concatenate(
            [np.take(v, range(1, v.shape[ax]), axis=ax),
             np.take(v, [v.shape[ax] - 1], axis=ax)], axis=ax)
        mid = (0.5 * (v + nxt)).astype(v.dtype)
        v = np.stack([v, mid], axis=ax + 1).reshape(
            *v.shape[:ax], 2 * v.shape[ax], *v.shape[ax + 1:])
    return v


def _export_warp_host(warp_data, scale, perm, inv):
    """Full-res field (for ``scale`` 1 or 2) with the RAI component
    permutation and sign flips, on the host: the field is already there."""
    w = np.asarray(warp_data, np.float32)
    if scale == 2:
        w = _upsample2x_host(w) * np.float32(scale)
    elif scale != 1:
        raise ValueError(f"field export supports scale 1 or 2, got {scale}")
    return np.stack([np.float32(inv[i]) * w[..., perm[i]] for i in range(3)], axis=-1)


def postprocess_and_save(warp_data: np.ndarray, scale: int, fixed_proc: nifti.NiftiImage,
                         fixed_nii: nifti.NiftiImage, moving_nii: nifti.NiftiImage,
                         moved: np.ndarray, paths: dict, timings: dict | None = None,
                         device=None):
    """Shared output stage (``bids_registration.py:387-429``)."""
    _t = [time.time()]

    def _mk(key):
        if timings is not None:
            now = time.time()
            timings[key] = round(now - _t[0], 3)
            _t[0] = now

    if "moved_proc" in paths:
        nifti.save(nifti.NiftiImage(np.asarray(moved, np.float32), fixed_proc.affine),
                   paths["moved_proc"])
    _mk("postprocess.save_moved_proc")

    # RAI permutation / sign flips for sct_apply_transfo
    fx_orient = list(nifti.aff2axcodes(-np.asarray(fixed_nii.affine)))
    opposite = {"L": "R", "R": "L", "A": "P", "P": "A", "I": "S", "S": "I"}
    perm, inversion = [0, 1, 2], [1, 1, 1]
    for i, ch in enumerate("RAI"):
        if ch in fx_orient:
            perm[i] = fx_orient.index(ch)
        else:
            perm[i] = fx_orient.index(opposite[ch])
            inversion[i] = -1

    warp_rai = _export_warp_host(warp_data, int(scale), perm, inversion)
    warp_exp = warp_rai[:, :, :, None, :]  # add the time axis
    _mk("postprocess.field_export")

    moved_orig = warp_orig = None
    if "moved_orig" in paths or "warp_orig" in paths:
        M = np.linalg.inv(fixed_proc.affine) @ moving_nii.affine
        identity = tuple(moving_nii.shape[:3]) == tuple(np.shape(moved)[:3]) and np.allclose(
            M, np.eye(4), rtol=0, atol=1e-9)
        if identity:
            moved_orig = np.asarray(moved, np.float64)
            warp_orig = warp_exp
        else:
            stacked = np.concatenate([np.asarray(moved, np.float32)[..., None], warp_rai], axis=-1)
            res = affine_resample(stacked, fixed_proc.affine, moving_nii.affine,
                                  moving_nii.shape[:3], "spline", device=device)
            moved_orig = res[..., 0]
            warp_orig = np.ascontiguousarray(res[..., 1:], dtype=np.float32)[:, :, :, None, :]
    _mk("postprocess.resample_orig")

    if "moved_orig" in paths:
        nifti.save(nifti.NiftiImage(moved_orig.astype(np.float32), moving_nii.affine),
                   paths["moved_orig"])
    _mk("postprocess.save_moved_orig")

    warp_img = nifti.NiftiImage(warp_exp, fixed_proc.affine)
    warp_img.header["intent_code"] = 1007
    if "warp_proc" in paths:
        nifti.save(warp_img, paths["warp_proc"])
    _mk("postprocess.save_warp_proc")

    if "warp_orig" in paths:
        warp_orig_img = nifti.NiftiImage(np.asarray(warp_orig, np.float32), moving_nii.affine)
        warp_orig_img.header["intent_code"] = 1007
        nifti.save(warp_orig_img, paths["warp_orig"])
    _mk("postprocess.save_warp_orig")
    return moved_orig, warp_exp


def warp_interp_of(cfg: InferenceConfig) -> str:
    """The config's warp interpolation; anything but nearest is linear."""
    return cfg.warp_interpolation if cfg.warp_interpolation in ("linear", "nearest") else "linear"


def blend_tiles(warps, coords, mov_shape, model_in_shape, device=None):
    """Blend per-tile fields ``(T, ...)`` into one ``(X, Y, Z, 3)`` field on
    the device -> ``(field, scale)``. Half-resolution tiles (scale 2) blend
    on the halved volume, tile and coordinates (integer ``// 2``)."""
    model_in, mshape, cds = list(model_in_shape), list(mov_shape), list(coords)
    if warps.shape[1] != model_in_shape[0]:
        scale = 2
        model_in = [s // 2 for s in model_in]
        mshape = [s // 2 for s in mshape]
        cds = [tuple(c // 2 for c in co) for co in cds]
    else:
        scale = 1
    return blend_subvol_fields(tuple(model_in), tuple(mshape), cds, warps, device=device), scale


def tiles_of(pre):
    """The stacked ``(fixed, moving)`` tiles of a preprocessed pair."""
    return np.stack(pre.subvols_fx), np.stack(pre.subvols_mov)


def _infer_fields_single(cfg, registrar, pre):
    """Run the model; return (moved_proc, warp_data, scale)."""
    warp_interp = warp_interp_of(cfg)
    mov_data = pre.moving.get_fdata()
    fx_data = pre.fixed.get_fdata()
    dev, impl = registrar.device, registrar.impl
    if not cfg.use_subvol:
        moved_b, warp_b = registrar.predict(mov_data[None], fx_data[None])
        warp_data = warp_b[0]
        scale = 1 if warp_data.shape[0] == pre.model_in_shape[0] else 2
        if warp_interp == "linear":
            moved = moved_b[0]
        else:
            moved = apply_warp(mov_data, warp_data, "nearest", rescale=scale, device=dev,
                               impl=impl)
        return moved, warp_data, scale

    # subvolumes: the tiles in chunks of max_batch, blended on the device
    fx_tiles, mov_tiles = tiles_of(pre)
    _, warps = registrar.predict_tensors(mov_tiles, fx_tiles)
    warp_data, scale = blend_tiles(warps, pre.subvol_coords, mov_data.shape,
                                   pre.model_in_shape, device=dev)
    moved = apply_warp(mov_data, warp_data, warp_interp, rescale=scale, device=dev, impl=impl)
    return moved, warp_data.cpu().numpy(), scale


def register(cfg: InferenceConfig, registrar: Registrar, fx_im_path: str, mov_im_path: str,
             fx_contrast: str = "T1w", naming: str = "bids", res_dir: str = "res",
             out_im_name: str = "warped_im", out_field_name: str = "deform_field",
             fixed_nii: "nifti.NiftiImage | None" = None,
             moving_nii: "nifti.NiftiImage | None" = None):
    """Register moving -> fixed and write the reference's output files.

    ``naming='bids'`` mirrors ``bids_registration.py``; ``'standalone'``
    mirrors ``3d_reg.py`` (moved image and field in original space go into
    ``res_dir``). Runs on the registrar's device.
    """
    timings = {}
    t = [time.time()]

    def _mark(phase):
        now = time.time()
        timings[phase] = round(now - t[0], 3)
        t[0] = now

    if fixed_nii is None:
        fixed_nii = nifti.load(fx_im_path)
    if moving_nii is None:
        moving_nii = nifti.load(mov_im_path)
    fx_stem = fx_im_path.split(".")[0]
    mov_stem = mov_im_path.split(".")[0]
    _mark("load")

    pre = preprocess(cfg, fixed_nii, moving_nii, device=registrar.device, impl=registrar.impl)
    _mark("preprocess")
    nifti.save(pre.fixed, f"{fx_stem}_proc.nii.gz")
    nifti.save(pre.moving, f"{mov_stem}_proc.nii.gz")
    _mark("save_proc")

    moved, warp_data, scale = _infer_fields_single(cfg, registrar, pre)
    _mark("predict")

    paths = {
        "moved_proc": f"{mov_stem}_proc_reg_to_{fx_contrast}.nii.gz",
        "warp_proc": f"{mov_stem}_proc_field_to_{fx_contrast}.nii.gz",
    }
    if naming == "bids":
        paths["moved_orig"] = f"{mov_stem}_reg_original_dim.nii.gz"
        paths["warp_orig"] = f"{mov_stem}_warp_original_dim.nii.gz"
    else:
        os.makedirs(res_dir, exist_ok=True)
        paths["moved_orig"] = os.path.join(res_dir, f"{out_im_name}.nii.gz")
        paths["warp_orig"] = os.path.join(res_dir, f"{out_field_name}.nii.gz")

    moved_orig, warp_exp = postprocess_and_save(
        warp_data, scale, pre.fixed, fixed_nii, moving_nii, moved, paths,
        timings=timings, device=registrar.device)
    _mark("postprocess")
    return {
        "moved": moved,
        "moved_orig": moved_orig,
        "warp": warp_exp,
        "warp_data": warp_data,
        "paths": paths,
        "scale": scale,
        "timings": timings,
    }


def load_params_any(path: str, cfg: InferenceConfig) -> dict:
    """Model weights for the port from a flat ``.npz`` checkpoint of the JAX
    package or a Keras VoxelMorph ``.h5`` (state dict on the CPU;
    ``Registrar`` moves it)."""
    vxm_cfg = vxm_config_from(cfg)
    if path.endswith((".h5", ".hdf5")):
        from multimodal_registration_torch.models.h5_import import import_keras_vxm_h5

        try:
            return import_keras_vxm_h5(path, vxm_cfg)
        except (KeyError, ValueError) as e:
            raise _arch_hint(path, cfg, e) from e
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path!r}: only .npz checkpoints load in the port; Orbax checkpoint "
            "directories are not read (ROADMAP queue 1 item 9c): use the flat .npz "
            "written beside them")
    with np.load(path) as z:
        flat = dict(z)
    try:
        return params_from_jax(flat, vxm_cfg)
    except (KeyError, ValueError) as e:
        raise _arch_hint(path, cfg, e) from e


def _arch_hint(path: str, cfg: InferenceConfig, e: Exception) -> ValueError:
    return ValueError(
        f"checkpoint {path!r} does not match the config's architecture "
        f"(enc={list(cfg.enc)}, dec={list(cfg.dec)}) — point --config-path "
        f"at the config this model was trained/exported with. Underlying "
        f"error: {e}")
