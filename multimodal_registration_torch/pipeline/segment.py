"""Pluggable spinal-cord segmentation + the center-of-mass affine fallback
(the port's copy of ``multimodal_registration_tpu/pipeline/segment.py``).

Parity targets:
  * SCT ``sct_deepseg_sc -i vol -c <contrast>``
    (`pipeline_bids_register_evaluate.sh:34-41`) — wrapped when the SCT CLI is
    on PATH; otherwise a built-in intensity segmenter keeps the pipeline
    runnable end-to-end,
  * SCT ``sct_register_multimodal … step=1,type=seg,algo=centermass``
    (`pipeline_bids_register_evaluate_opt_affine.sh:174`) — a slice-wise
    center-of-mass translation computed on the segmentations, realized as a
    dense warp field and applied by kernel K2 on the registrar's device
    (:func:`apply_affine_field`).
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np

from multimodal_registration_torch.utils import nifti

# contrast → sct_deepseg_sc -c value (pipeline_bids_register_evaluate.sh:36-39)
_SCT_CONTRAST = {"T1w": "t1", "T2w": "t2", "T2star": "t2s", "dwi": "dwi"}


class Segmenter:
    """Interface: __call__(image_path, contrast, out_path) -> out_path."""

    def __call__(self, image_path: str, contrast: str, out_path: str) -> str:
        raise NotImplementedError


class SCTSegmenter(Segmenter):
    """Shells out to ``sct_deepseg_sc`` (requires the SCT toolbox)."""

    @staticmethod
    def available() -> bool:
        return shutil.which("sct_deepseg_sc") is not None

    def __call__(self, image_path: str, contrast: str, out_path: str) -> str:
        # external process reads from disk — pending write-behind saves of the
        # input must land first
        nifti.flush_writes()
        c = _SCT_CONTRAST.get(contrast, contrast.lower())
        subprocess.run(
            ["sct_deepseg_sc", "-i", image_path, "-c", c, "-o", out_path],
            check=True,
        )
        return out_path


class ThresholdSegmenter(Segmenter):
    """Fallback segmenter: bright-structure threshold + largest connected
    component. Keeps the full pipeline runnable without SCT; replace with
    SCTSegmenter (or any callable) in production."""

    def __init__(self, percentile: float = 97.0):
        self.percentile = percentile

    def __call__(self, image_path: str, contrast: str, out_path: str) -> str:
        from scipy import ndimage

        img = nifti.load(image_path, cached=True)
        data = img.get_fdata()
        thr = np.percentile(data, self.percentile)
        mask = data >= thr
        lab, n = ndimage.label(mask)
        if n > 1:
            sizes = ndimage.sum(mask, lab, range(1, n + 1))
            mask = lab == (1 + int(np.argmax(sizes)))
        out = nifti.NiftiImage(mask.astype(np.uint8), img.affine)
        nifti.save(out, out_path)
        return out_path


def default_segmenter() -> Segmenter:
    return SCTSegmenter() if SCTSegmenter.available() else ThresholdSegmenter()


def centermass_affine_field(fx_seg: np.ndarray, mov_seg: np.ndarray) -> np.ndarray:
    """Slice-wise center-of-mass alignment field ``(X, Y, Z, 3)`` that maps the
    moving segmentation onto the fixed one (z slices are the cord axis).

    Equivalent role to SCT's ``algo=centermass``
    (`pipeline_bids_register_evaluate_opt_affine.sh:174`): per z-slice, the
    in-plane translation between the segmentation centroids; slices without
    cord pixels inherit the nearest valid slice's translation.
    """
    X, Y, Z = fx_seg.shape
    tx = np.zeros(Z)
    ty = np.zeros(Z)
    valid = np.zeros(Z, bool)
    xs = np.arange(X)[:, None]
    ys = np.arange(Y)[None, :]
    for z in range(Z):
        f, m = fx_seg[:, :, z], mov_seg[:, :, z]
        if f.sum() > 0 and m.sum() > 0:
            fx_com = (np.sum(xs * f) / f.sum(), np.sum(ys * f) / f.sum())
            mv_com = (np.sum(xs * m) / m.sum(), np.sum(ys * m) / m.sum())
            # displacement field convention: moved(x) = mov(x + phi(x)), so to
            # place the moving centroid at the fixed centroid: phi = com_m - com_f
            tx[z] = mv_com[0] - fx_com[0]
            ty[z] = mv_com[1] - fx_com[1]
            valid[z] = True
    if valid.any():
        idx = np.where(valid)[0]
        # nearest-valid fill (then the ends are constant-extended)
        all_z = np.arange(Z)
        nearest = idx[np.argmin(np.abs(all_z[:, None] - idx[None, :]), axis=1)]
        tx = tx[nearest]
        ty = ty[nearest]
    field = np.zeros((X, Y, Z, 3), np.float32)
    field[..., 0] = tx[None, None, :]
    field[..., 1] = ty[None, None, :]
    return field


def rigid_affine_field(fx_seg: np.ndarray, mov_seg: np.ndarray) -> np.ndarray:
    """Opt-in rigid (rotation + translation) fallback field from segmentation
    moments — NOT part of the reference, whose affine fallback is slice-wise
    center-of-mass only (`pipeline_bids_register_evaluate_opt_affine.sh:174`)
    and therefore cannot correct rotation-dominant misalignment
    (benchmarks/opt_affine_rotation_study.py). Enable with
    ``PipelineConfig.affine_fallback_mode='rigid'``.

    Estimates R, t by principal-axes (inertia-tensor) alignment of the two
    binary segmentations: eigenvector signs are chosen to minimize the
    rotation angle (valid for the small-angle regime the gate fires in), and
    the returned dense field maps fixed-grid coordinates into moving space:
    ``phi(x) = c_m + R (x - c_f) - x`` under ``moved(x) = mov(x + phi(x))``.
    """

    def moments(seg):
        m = seg.astype(np.float64)
        tot = m.sum()
        if tot == 0:
            return None, None
        idx = [np.arange(s, dtype=np.float64) for s in seg.shape]
        com = np.array([
            (m.sum(axis=(1, 2)) * idx[0]).sum(),
            (m.sum(axis=(0, 2)) * idx[1]).sum(),
            (m.sum(axis=(0, 1)) * idx[2]).sum(),
        ]) / tot
        # second moments about the COM
        g = np.stack(np.meshgrid(*idx, indexing="ij"), -1) - com
        w = m[..., None]
        cov = np.einsum("xyzi,xyzj->ij", g * w, g) / tot
        return com, cov

    c_f, S_f = moments(fx_seg)
    c_m, S_m = moments(mov_seg)
    X, Y, Z = fx_seg.shape
    field = np.zeros((X, Y, Z, 3), np.float32)
    if c_f is None or c_m is None:
        return field
    wf, Uf = np.linalg.eigh(S_f)
    wm, Um = np.linalg.eigh(S_m)
    # sign-fix each moving eigenvector toward its fixed counterpart so the
    # rotation is the small one (eigenvectors have arbitrary sign)
    for k in range(3):
        if np.dot(Um[:, k], Uf[:, k]) < 0:
            Um[:, k] = -Um[:, k]
    R = Um @ Uf.T
    if np.linalg.det(R) < 0:  # guard against a reflection from degenerate axes
        k = int(np.argmin(np.abs(wm)))
        Um[:, k] = -Um[:, k]
        R = Um @ Uf.T
    grid = np.stack(np.meshgrid(
        np.arange(X, dtype=np.float64), np.arange(Y, dtype=np.float64),
        np.arange(Z, dtype=np.float64), indexing="ij"), -1)
    target = c_m + (grid - c_f) @ R.T
    return (target - grid).astype(np.float32)


def apply_affine_field(image_path: str, field: np.ndarray, out_path: str, interp="linear",
                       device=None, impl=None):
    """Warp a volume by the (full-resolution) field on ``device`` (kernel K2
    on the card; ``impl="plain"`` its plain version) and save it."""
    import torch

    from multimodal_registration_torch.device import resolve_device
    from multimodal_registration_torch.infer.register import on_device
    from multimodal_registration_torch.ops.warp import warp as device_warp

    dev = resolve_device(device)
    img = nifti.load(image_path, cached=True)
    with torch.inference_mode():
        moved = device_warp(on_device(img.get_fdata(), dev), on_device(field, dev), interp,
                            impl=impl).cpu().numpy()
    nifti.save(nifti.NiftiImage(moved, img.affine), out_path)
    return out_path
