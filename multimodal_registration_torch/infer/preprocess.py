"""Inference preprocessing: scaling, 1 mm resampling, shape normalization
and the subvolume tile grid.

Counterpart of ``multimodal_registration_tpu/infer/preprocess.py``:

  1. min-max scale both volumes to [0, 1],
  2. resample the fixed volume to 1 mm isotropic and the moving volume onto
     the fixed grid (on the device: kernel K2 for linear/nearest, the
     quadratic device spline of ``ops/resample.py`` for spline),
  3. common shape = lexicographic ``max`` of the two shapes (reference
     quirk) rounded to a multiple of 16, then pad/crop to it,
  4. with ``use_subvol``, cut overlapping tiles (:func:`subvol_grid`), which
     ``register`` runs through the model and blends (:mod:`infer.blend`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.ops.resample import pad_or_crop, resample_nib
from multimodal_registration_torch.utils import nifti


def _norm_interp(name: str) -> str:
    if name not in ("nearest", "linear", "spline"):
        return "linear"
    return "nn" if name == "nearest" else name


def minmax_scale(x: np.ndarray) -> np.ndarray:
    lo, hi = np.min(x), np.max(x)
    rng = hi - lo
    if rng == 0:
        return np.zeros_like(x)
    return (x - lo) / rng


def subvol_grid(cfg: InferenceConfig, vol_shape) -> Tuple[tuple, list]:
    """Tile coordinates for overlapping subvolumes (the JAX package's
    ``subvol_grid``, itself ``bids_registration.py:177-219``)."""
    in_shape = tuple(cfg.round16(s, axis=i) for i, s in enumerate(cfg.subvol_size))
    min_perc = cfg.min_perc_overlap
    if min_perc >= 1:
        min_perc = min_perc / 100 if min_perc / 100 < 1 else 0.1
    elif min_perc <= 0:
        min_perc = 0.1

    counts = [int(vol_shape[a] / (in_shape[a] - min_perc * in_shape[a])) + 1 for a in range(3)]
    overlaps = [0.0, 0.0, 0.0]
    for a in range(3):
        if counts[a] > 1:
            overlaps[a] = (in_shape[a] - (vol_shape[a] / counts[a])) * (
                counts[a] / (counts[a] - 1))
    for a in range(3):
        if vol_shape[a] < in_shape[a]:
            raise ValueError(
                f"subvol_size {in_shape} exceeds the preprocessed volume shape "
                f"{tuple(vol_shape)} on axis {a}; disable use_subvol or shrink it")

    def _clamp(lo: int, axis: int) -> tuple:
        # shift an over-long tile back inside so every tile keeps the shape
        hi = lo + in_shape[axis]
        if hi > vol_shape[axis]:
            hi = vol_shape[axis]
            lo = hi - in_shape[axis]
        return lo, hi

    coords = []
    x_max = y_max = z_max = 0
    for i in range(counts[0]):
        x_min, x_max = _clamp(0 if i == 0 else int(x_max - overlaps[0]), 0)
        for j in range(counts[1]):
            y_min, y_max = _clamp(0 if j == 0 else int(y_max - overlaps[1]), 1)
            for k in range(counts[2]):
                z_min, z_max = _clamp(0 if k == 0 else int(z_max - overlaps[2]), 2)
                coords.append((x_min, x_max, y_min, y_max, z_min, z_max))
    return in_shape, coords


@dataclass
class PreprocessResult:
    fixed: nifti.NiftiImage  # *_proc fixed volume (1 mm iso, padded)
    moving: nifti.NiftiImage  # *_proc moving volume (on the fixed grid)
    subvols_fx: List[np.ndarray]
    subvols_mov: List[np.ndarray]
    subvol_coords: List[tuple]
    model_in_shape: tuple


def preprocess(cfg: InferenceConfig, fixed_nii: nifti.NiftiImage,
               moving_nii: nifti.NiftiImage, device=None, impl=None) -> PreprocessResult:
    interp = _norm_interp(cfg.resample_interpolation)
    fx = minmax_scale(fixed_nii.get_fdata())
    mov = minmax_scale(moving_nii.get_fdata())

    fx_res = resample_nib(nifti.NiftiImage(fx, fixed_nii.affine), new_size=[1, 1, 1],
                          new_size_type="mm", interpolation=interp, mode="constant",
                          device=device, impl=impl)
    mov_res = resample_nib(nifti.NiftiImage(mov, moving_nii.affine), image_dest=fx_res,
                           interpolation=interp, mode="constant", device=device, impl=impl)

    # lexicographic max of shapes: the reference's `max(tuple, tuple)` quirk
    max_shape = max(tuple(fx_res.shape), tuple(mov_res.shape))
    new_shape = tuple(cfg.round16(s, axis=i) for i, s in enumerate(max_shape))

    fx_data = pad_or_crop(fx_res.get_fdata(), new_shape)
    mov_data = pad_or_crop(mov_res.get_fdata(), new_shape)

    subvols_fx, subvols_mov, coords = [], [], []
    if cfg.use_subvol:
        model_in_shape, coords = subvol_grid(cfg, new_shape)
        for (x0, x1, y0, y1, z0, z1) in coords:
            subvols_fx.append(fx_data[x0:x1, y0:y1, z0:z1])
            subvols_mov.append(mov_data[x0:x1, y0:y1, z0:z1])
    else:
        model_in_shape = new_shape

    return PreprocessResult(
        fixed=nifti.NiftiImage(fx_data, fx_res.affine),
        moving=nifti.NiftiImage(mov_data, fx_res.affine),
        subvols_fx=subvols_fx,
        subvols_mov=subvols_mov,
        subvol_coords=coords,
        model_in_shape=model_in_shape,
    )
