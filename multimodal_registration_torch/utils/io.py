"""Volume I/O helpers (``vxm.py.utils`` load/save surface), the port's own
copy of ``multimodal_registration_tpu/utils/io.py`` on the port's
``utils/nifti.py`` (pure-Python reader; the native reader is not ported).

  * ``load_volfile`` / ``save_volfile``: NIfTI, ``.npy`` and ``.npz`` to and
    from numpy, with ``add_batch_axis`` / ``add_feat_axis`` / ``ret_affine``;
  * ``load_labels``: scan a directory of label maps and return
    ``(unique labels, list of maps)``.
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_registration_torch.utils import nifti


def load_volfile(path: str, add_batch_axis: bool = False, add_feat_axis: bool = False,
                 ret_affine: bool = False, np_var: str = "vol"):
    if path.endswith((".nii", ".nii.gz")):
        img = nifti.load(path)
        vol = img.get_fdata(dtype=np.float32)
        affine = img.affine
    elif path.endswith(".npy"):
        vol = np.load(path)
        affine = np.eye(4)
    elif path.endswith(".npz"):
        vol = np.load(path)[np_var]
        affine = np.eye(4)
    else:
        raise ValueError(f"unknown volume filetype: {path}")
    if add_feat_axis:
        vol = vol[..., None]
    if add_batch_axis:
        vol = vol[None, ...]
    return (vol, affine) if ret_affine else vol


def save_volfile(vol: np.ndarray, path: str, affine=None):
    if affine is None:
        affine = np.eye(4)
    if path.endswith((".nii", ".nii.gz")):
        nifti.save(nifti.NiftiImage(np.asarray(vol), affine), path)
    elif path.endswith(".npy"):
        np.save(path, vol)
    else:
        raise ValueError(f"unknown volume filetype: {path}")


def load_labels(label_dir: str):
    """Load all label maps in a directory; returns ``(unique_labels, maps)``."""
    paths = sorted(
        os.path.join(label_dir, f)
        for f in os.listdir(label_dir)
        if f.endswith((".nii", ".nii.gz", ".npy", ".npz"))
    )
    if not paths:
        raise FileNotFoundError(f"no label maps found in {label_dir}")
    maps = [np.asarray(load_volfile(p)).astype(np.uint8) for p in paths]
    labels = np.unique(np.concatenate([np.unique(m) for m in maps]))
    return labels, maps
