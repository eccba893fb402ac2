"""Affine grid resampling (NIfTI grid -> NIfTI grid).

Counterpart of ``multimodal_registration_tpu/ops/resample.py``:
``resample_nib`` (the reference's header-affine resampling), ``pad_or_crop``
and ``affine_resample``. For each output voxel ``v`` the input is sampled at
``inv(A_in) @ A_out @ v``.

Ported: the identity map (same grid: the input itself; same affine, other
shape: a zero-filled pad/crop from the origin, exact for every
interpolation order under the 'constant' boundary) and orders 0/1 through
:func:`ops.warp.sample` (kernel K2 on the card). A non-identity spline
(order >= 2) raises: the device spline waits for ROADMAP queue 1 item 10,
and it never goes to scipy in its place.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device
from multimodal_registration_torch.ops.warp import sample
from multimodal_registration_torch.utils import nifti

# 'spline' = cubic (the postprocess 'continuous' parity); 'spline2' =
# quadratic, what the reference's resample_nib means by 'spline'
_ORDER = {"nn": 0, "nearest": 0, "linear": 1, "spline": 3, "spline2": 2}


def pad_or_crop(data: np.ndarray, target_shape, cval=0.0) -> np.ndarray:
    """``nilearn.resample_img(target_affine=same, target_shape=...)``
    parity: with an identical affine, resampling is a ``cval``-filled pad /
    crop anchored at the origin."""
    out = np.full(tuple(target_shape) + data.shape[3:], cval, dtype=data.dtype)
    src = tuple(slice(0, min(s, t)) for s, t in zip(data.shape, target_shape))
    out[src] = data[src]
    return out


def affine_resample(vol: np.ndarray, in_affine: np.ndarray, out_affine: np.ndarray,
                    out_shape, interpolation: str = "linear", mode: str = "constant",
                    cval: float = 0.0, device=None) -> np.ndarray:
    """Resample ``vol (X, Y, Z[, C])`` from grid ``in_affine`` onto
    ``(out_shape, out_affine)``; channels ride along. Returns float64."""
    order = _ORDER[interpolation]
    out_shape = tuple(int(s) for s in out_shape)
    M = np.linalg.inv(in_affine) @ out_affine
    if np.allclose(M, np.eye(4), rtol=0, atol=1e-9):
        if out_shape == tuple(vol.shape[:3]):
            return np.asarray(vol, np.float64)
        if mode == "constant":
            # integer sample points reproduce the input at every order;
            # points outside [0, n-1] are cval
            return pad_or_crop(np.asarray(vol, np.float64), out_shape, cval)
    if order >= 2:
        raise NotImplementedError(
            f"spline resampling (order {order}) on a non-identity grid map is not "
            "ported yet (ROADMAP queue 1 item 10)")
    dev = resolve_device(device)
    volt = torch.as_tensor(np.asarray(vol, np.float32), device=dev)
    Mt = torch.as_tensor(M, dtype=torch.float32, device=dev)
    axes = [torch.arange(s, dtype=torch.float32, device=dev) for s in out_shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    coords = grid @ Mt[:3, :3].T + Mt[:3, 3]
    out = sample(volt, coords, interp="nearest" if order == 0 else "linear")
    if mode == "constant":
        # scipy's 'constant' boundary for order <= 1: a coordinate strictly
        # outside [0, n-1] on any axis yields cval
        in_dims = torch.tensor(vol.shape[:3], dtype=torch.float32, device=dev) - 1.0
        inside = ((coords >= 0.0) & (coords <= in_dims)).all(dim=-1)
        if out.ndim == 4:
            inside = inside[..., None]
        out = torch.where(inside, out, torch.full_like(out, cval))
    return out.cpu().numpy().astype(np.float64)


def resample_nib(image: nifti.NiftiImage, new_size=None, new_size_type=None,
                 image_dest: nifti.NiftiImage | None = None,
                 interpolation: str = "linear", mode: str = "nearest",
                 device=None) -> nifti.NiftiImage:
    """Drop-in equivalent of the reference's ``resample_nib``, 3-D and 4-D
    volumes. The reference's 'spline' here is quadratic (order 2)."""
    if interpolation == "spline":
        interpolation = "spline2"
    img = image
    affine = np.array(img.affine, dtype=np.float64)
    affine[3, :] = [0, 0, 0, 1]

    if image_dest is None:
        p = img.header.get_zooms()
        shape = img.shape
        if img.ndim == 4:
            new_size = list(new_size)
            if len(new_size) == 3:
                new_size += ["1"]
        if new_size_type == "vox":
            shape_r = tuple(int(new_size[i]) for i in range(img.ndim))
        elif new_size_type == "factor":
            if len(new_size) == 1:
                new_size = tuple(new_size[0] for _ in range(img.ndim))
            shape_r = tuple(int(np.round(shape[i] * float(new_size[i])))
                            for i in range(img.ndim))
        elif new_size_type == "mm":
            if len(new_size) == 1:
                new_size = tuple(new_size[0] for _ in range(img.ndim))
            shape_r = tuple(int(np.round(shape[i] * float(p[i]) / float(new_size[i])))
                            for i in range(img.ndim))
        else:
            raise ValueError("'new_size_type' is not recognized.")
        R = np.eye(4)
        for i in range(3):
            if shape_r[i] == 0:
                raise ZeroDivisionError(f"Destination size is zero for dimension {i}")
            R[i, i] = img.shape[i] / float(shape_r[i])
        ref_shape, ref_affine = shape_r, affine @ R
    else:
        ref_shape, ref_affine = image_dest.shape[:3], image_dest.affine

    data = img.get_fdata()
    kw = dict(mode=mode, cval=0.0, device=device)
    if img.ndim == 3:
        out = affine_resample(data, affine, ref_affine, ref_shape[:3], interpolation, **kw)
        return nifti.NiftiImage(out.astype(np.float64), ref_affine)
    if img.ndim == 4:
        out4 = np.zeros((*ref_shape[:3], img.shape[3]))
        for t in range(img.shape[3]):
            out4[..., t] = affine_resample(data[..., t], affine, ref_affine,
                                           ref_shape[:3], interpolation, **kw)
        return nifti.NiftiImage(out4, ref_affine)
    raise ValueError(f"unsupported ndim {img.ndim}")
