"""Single-model registration flow: preprocess -> model -> field assembly ->
NIfTI postprocess.

Counterpart of ``multimodal_registration_tpu/infer/register.py``, with the
same output-file names (``*_proc``, ``*_proc_reg_to_<CONTRAST>``,
``*_proc_field_to_<CONTRAST>`` with NIfTI intent 1007, and the moved image
and field on the original moving grid), the same RAI export of the field and
the same ``timings`` keys. Everything runs on ``cuda`` unless the
``Registrar`` was built with ``device="cpu"``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.infer.config import InferenceConfig, check_supported
from multimodal_registration_torch.infer.preprocess import preprocess
from multimodal_registration_torch.models.vxm_dense import VxmConfig, VxmDense
from multimodal_registration_torch.models.weights import params_from_jax
from multimodal_registration_torch.ops.resample import affine_resample
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.ops.warp import warp as device_warp
from multimodal_registration_torch.utils import nifti


def vxm_config_from(cfg: InferenceConfig) -> VxmConfig:
    """The model config an :class:`InferenceConfig` maps to."""
    return VxmConfig(
        enc=tuple(cfg.enc),
        dec=tuple(cfg.dec),
        int_steps=cfg.int_steps,
        int_res=cfg.int_res,
        svf_res=cfg.svf_res,
        compute_dtype=cfg.compute_dtype,
        svf_smooth_sigma=float(cfg.svf_smooth_sigma or 0.0),
        quantize=str(cfg.quantize or ""),
    )


class Registrar:
    """Holds the model on its device. Batches larger than ``max_batch`` run
    in chunks of ``max_batch`` pairs, the last one zero-padded, so every
    call sees the same shapes and activation memory stays bounded."""

    def __init__(self, cfg: InferenceConfig, params: dict, max_batch: int = 4,
                 device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.vxm_cfg = vxm_config_from(cfg)
        self.model = VxmDense(self.vxm_cfg, device=self.device).eval()
        self.model.load_state_dict(params)
        self.max_batch = max_batch

    @torch.inference_mode()
    def predict(self, mov: np.ndarray, fx: np.ndarray):
        """Batched predict on ``(B, X, Y, Z)`` arrays -> ``(moved, warp)``:
        ``(B, X, Y, Z)`` and the int-res field ``(B, x, y, z, 3)``."""
        B = mov.shape[0]
        chunk = min(self.max_batch, B)
        moved_parts, warp_parts = [], []
        for s in range(0, B, chunk):
            m = np.asarray(mov[s: s + chunk], np.float32)
            f = np.asarray(fx[s: s + chunk], np.float32)
            n = m.shape[0]
            if n < chunk:
                pad = chunk - n
                m = np.concatenate([m, np.zeros((pad, *m.shape[1:]), np.float32)])
                f = np.concatenate([f, np.zeros((pad, *f.shape[1:]), np.float32)])
            mt = torch.from_numpy(m).to(self.device)[..., None]
            ft = torch.from_numpy(f).to(self.device)[..., None]
            out = self.model(mt, ft)
            moved_parts.append(out["moved"][..., 0].cpu().numpy()[:n])
            warp_parts.append(out["warp"].cpu().numpy()[:n])
        return np.concatenate(moved_parts), np.concatenate(warp_parts)


@torch.inference_mode()
def apply_warp(vol: np.ndarray, field: np.ndarray, interp: str, rescale: int = 1,
               device=None) -> np.ndarray:
    """``vxm.networks.Transform(rescale=...)`` parity: upsample the field by
    ``rescale`` (scaling vectors), then warp."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(vol, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(field, np.float32), device=dev)
    if rescale != 1:
        f = rescale_field(f, int(rescale), out_shape=tuple(vol.shape[:3]))
    return device_warp(v, f, interp=interp).cpu().numpy()


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


def _infer_fields_single(cfg, registrar, pre):
    """Run the model; return (moved_proc, warp_data, scale)."""
    warp_interp = cfg.warp_interpolation if cfg.warp_interpolation in ("linear", "nearest") else "linear"
    mov_data = pre.moving.get_fdata()
    fx_data = pre.fixed.get_fdata()
    moved_b, warp_b = registrar.predict(mov_data[None], fx_data[None])
    warp_data = warp_b[0]
    scale = 1 if warp_data.shape[0] == pre.model_in_shape[0] else 2
    if warp_interp == "linear":
        moved = moved_b[0]
    else:
        moved = apply_warp(mov_data, warp_data, "nearest", rescale=scale,
                           device=registrar.device)
    return moved, warp_data, scale


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
    if cfg.use_subvol:
        raise NotImplementedError(
            "use_subvol (subvolume tiling and blending) is not ported yet "
            "(ROADMAP queue 1 item 9b)")
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

    pre = preprocess(cfg, fixed_nii, moving_nii, device=registrar.device)
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
    package (state dict on the CPU; ``Registrar`` moves it)."""
    if path.endswith((".h5", ".hdf5")):
        raise NotImplementedError(
            "Keras .h5 import is not ported yet (ROADMAP queue 1 item 9c, h5 import)")
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path!r}: only .npz checkpoints load in the port; Orbax checkpoint "
            "directories are not read (ROADMAP queue 1 item 9c): use the flat .npz "
            "written beside them")
    vxm_cfg = vxm_config_from(cfg)
    with np.load(path) as z:
        flat = dict(z)
    try:
        return params_from_jax(flat, vxm_cfg)
    except (KeyError, ValueError) as e:
        raise ValueError(
            f"checkpoint {path!r} does not match the config's architecture "
            f"(enc={list(cfg.enc)}, dec={list(cfg.dec)}) — point --config-path "
            f"at the config this model was trained/exported with. Underlying "
            f"error: {e}") from e
