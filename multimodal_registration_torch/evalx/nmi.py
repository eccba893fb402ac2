"""Normalized mutual information (Studholme) from a joint histogram built
on the device.

Counterpart of ``multimodal_registration_tpu/evalx/nmi.py``:
``detect_zero_padding`` (bounding box of the non-zero mass) and
``normalized_mutual_information``: each image, rounded to float32, binned
in float64 over its own ``[min, max]`` into 100 bins (right edge of the last
bin inclusive), NMI = (H0 + H1) / H01 with natural-log entropies. The bin
indices and the joint histogram are computed on the device; the entropies of
the 100 x 100 counts on the host, in the JAX package's order, so the values
(and the CSV rows written from them) are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device


def detect_zero_padding(im: np.ndarray):
    """``(x_min, y_min, z_min, x_max, y_max, z_max)`` of the non-zero region."""
    x = np.where(im.sum(axis=(1, 2)) > 0)[0]
    y = np.where(im.sum(axis=(0, 2)) > 0)[0]
    z = np.where(im.sum(axis=(0, 1)) > 0)[0]
    return x[0], y[0], z[0], x[-1], y[-1], z[-1]


def _bin_idx(x: torch.Tensor, bins: int) -> torch.Tensor:
    x = x.reshape(-1).double()
    lo, hi = x.min(), x.max()
    w = torch.clamp(hi - lo, min=1e-12)
    return torch.clamp(torch.floor((x - lo) / w * bins).long(), 0, bins - 1)


@torch.inference_mode()
def _joint_histogram(image0, image1, bins: int = 100, device=None) -> np.ndarray:
    """The ``(bins, bins)`` joint histogram (float64 counts) of two volumes,
    counted on the device."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(image0, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(image1, np.float32), device=dev)
    joint = torch.bincount(_bin_idx(a, bins) * bins + _bin_idx(b, bins), minlength=bins * bins)
    return joint.cpu().numpy().astype(np.float64).reshape(bins, bins)


def _entropy(p: np.ndarray) -> float:
    p = p / p.sum()
    nz = p[p > 0]
    return float(-(nz * np.log(nz)).sum())


def normalized_mutual_information(image0: np.ndarray, image1: np.ndarray, bins: int = 100,
                                  device=None) -> float:
    """NMI of two volumes."""
    joint = _joint_histogram(image0, image1, bins, device)
    return (_entropy(joint.sum(0)) + _entropy(joint.sum(1))) / _entropy(joint.reshape(-1))
