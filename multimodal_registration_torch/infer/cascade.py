"""Two-step (cascade) registration: a smooth first model, then a fine
deformable one, with dense-field composition.

Counterpart of ``multimodal_registration_tpu/infer/cascade.py``
(``register`` of the reference's ``bids_two_steps_registration.py``):

  * whole volume: ``model1(mov, fx) -> moved1``, ``model2(moved1, fx)``
    (with nearest warping, ``moved1`` is the processed moving volume warped
    by the rescaled first field), final field ``compose(warp1, warp2)``;
  * subvolumes, linear: per tile model 1 then model 2; with
    ``cascade_compose_res`` 'full' each step's tiles are blended and the two
    fields composed on the image grid, with 'int' the tiles are composed
    one by one and then blended;
  * subvolumes, nearest: model 1 through :meth:`Registrar.register_tensors`
    (tiles cut, blended and applied on the device), preprocess the
    moved volume again (a second tiling), model 2 on its tiles, blend
    ``warp2``, compose the two fields;
  * the postprocess of the single-model path.

The fields stay on the device between the steps; composition is kernel K2
on the card (:func:`ops.field.compose_fields`).
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_registration_torch.infer.config import InferenceConfig
from multimodal_registration_torch.infer.preprocess import preprocess
from multimodal_registration_torch.infer.register import (
    Registrar, apply_warp, blend_tiles, postprocess_and_save, tiles_of, warp_interp_of)
from multimodal_registration_torch.ops.field import compose_fields, compose_fields_batch
from multimodal_registration_torch.ops.resize import rescale_field
from multimodal_registration_torch.utils import nifti


def _compose_full(w1: torch.Tensor, w2: torch.Tensor, scale: int, out_shape, impl=None):
    """Upsample both step fields to the image grid and compose there: the
    interpolation of the smooth first field at the coarse grid is what folds
    the exported full-resolution field once it is upsampled."""
    w1f = rescale_field(w1, scale, out_shape=out_shape)
    w2f = rescale_field(w2, scale, out_shape=out_shape)
    return compose_fields(w1f, w2f, impl=impl)


def _compose_final(cfg, warp1, warp2, scale, full_shape, impl=None):
    """The final field under ``cfg.cascade_compose_res`` -> ``(field,
    scale)``: 'full' composes on the image grid (scale 1), 'int' at the
    field's own resolution (the postprocess upsamples it)."""
    if cfg.cascade_compose_res == "full" and scale != 1:
        return _compose_full(warp1, warp2, int(scale), tuple(full_shape), impl), 1
    return compose_fields(warp1, warp2, impl=impl), scale


@torch.inference_mode()
def register_two_steps(cfg: InferenceConfig, reg1: Registrar, reg2: Registrar,
                       fx_im_path: str, mov_im_path: str, fx_contrast: str = "T1w"):
    """Register moving -> fixed with ``reg1`` then ``reg2`` and write the
    single-model path's BIDS output files. Runs on ``reg1``'s device with
    its ``impl``."""
    warp_interp = warp_interp_of(cfg)
    dev, impl = reg1.device, reg1.impl
    fixed_nii = nifti.load(fx_im_path)
    moving_nii = nifti.load(mov_im_path)
    fx_stem = fx_im_path.split(".")[0]
    mov_stem = mov_im_path.split(".")[0]

    pre = preprocess(cfg, fixed_nii, moving_nii, device=dev, impl=impl)
    nifti.save(pre.fixed, f"{fx_stem}_proc.nii.gz")
    nifti.save(pre.moving, f"{mov_stem}_proc.nii.gz")
    mov_data = pre.moving.get_fdata()
    fx_data = pre.fixed.get_fdata()
    full_shape = mov_data.shape[:3]

    def blend(warps, p):
        return blend_tiles(warps, p.subvol_coords, p.moving.shape[:3], p.model_in_shape,
                           device=dev)

    if not cfg.use_subvol:
        moved1, warp1, scale = reg1.register_tensors(mov_data, fx_data, cfg)
        moved2_b, warp2_b = reg2.predict_tensors(moved1[None], fx_data[None])
        warp_data, scale = _compose_final(cfg, warp1, warp2_b[0], scale, full_shape, impl)
        if warp_interp == "linear":
            moved = moved2_b[0].cpu().numpy()
        else:
            moved = apply_warp(mov_data, warp_data, "nearest", rescale=scale, device=dev,
                               impl=impl)
    elif warp_interp == "linear":
        fx_tiles, mov_tiles = tiles_of(pre)
        moved1_t, warp1_t = reg1.predict_tensors(mov_tiles, fx_tiles)
        _, warp2_t = reg2.predict_tensors(moved1_t, fx_tiles)
        if cfg.cascade_compose_res == "full":
            # each step's tiles blended to a full-volume field, composed on
            # the image grid
            warp1_full, scale = blend(warp1_t, pre)
            warp2_full, _ = blend(warp2_t, pre)
            warp_data, scale = _compose_final(cfg, warp1_full, warp2_full, scale, full_shape,
                                              impl)
        else:
            # the reference's order: compose tile by tile (one batched
            # composition), then blend
            warp_data, scale = blend(compose_fields_batch(warp1_t, warp2_t, impl=impl), pre)
        moved = apply_warp(mov_data, warp_data, "linear", rescale=scale, device=dev, impl=impl)
    else:
        moved1, warp1_full, scale = reg1.register_tensors(mov_data, fx_data, cfg)
        moved1 = moved1.cpu().numpy()
        nifti.save(nifti.NiftiImage(warp1_full.cpu().numpy(), pre.fixed.affine),
                   f"{mov_stem}_first_proc_field_to_{fx_contrast}.nii.gz")
        nifti.save(nifti.NiftiImage(moved1, pre.fixed.affine),
                   f"{mov_stem}_proc_first_reg_to_{fx_contrast}.nii.gz")
        # the moved volume is preprocessed again and tiled anew
        pre2 = preprocess(cfg, fixed_nii, nifti.NiftiImage(moved1, pre.fixed.affine),
                          device=dev, impl=impl)
        fx_tiles2, mov_tiles2 = tiles_of(pre2)
        _, warp2_t = reg2.predict_tensors(mov_tiles2, fx_tiles2)
        warp2_full, scale2 = blend(warp2_t, pre2)
        if scale2 != scale:
            # the composition below needs both fields on one grid
            raise ValueError(
                f"cascade models disagree on field scale ({scale} vs {scale2}); use "
                "models with identical int_res")
        warp_data, scale = _compose_final(cfg, warp1_full, warp2_full, scale, full_shape, impl)
        moved = apply_warp(mov_data, warp_data, "nearest", rescale=scale, device=dev, impl=impl)

    warp_data = warp_data.cpu().numpy()
    paths = {
        "moved_proc": f"{mov_stem}_proc_reg_to_{fx_contrast}.nii.gz",
        "moved_orig": f"{mov_stem}_reg_original_dim.nii.gz",
        "warp_proc": f"{mov_stem}_proc_field_to_{fx_contrast}.nii.gz",
        "warp_orig": f"{mov_stem}_warp_original_dim.nii.gz",
    }
    moved_orig, warp_exp = postprocess_and_save(
        warp_data, scale, pre.fixed, fixed_nii, moving_nii, np.asarray(moved), paths, device=dev)
    return {
        "moved": moved,
        "moved_orig": moved_orig,
        "warp": warp_exp,
        "warp_data": warp_data,
        "paths": paths,
        "scale": scale,
    }
