"""Segmentation-overlap metrics, the confusion counts on the device.

Counterpart of ``multimodal_registration_tpu/evalx/overlap.py``: confusion
counts of a segmentation against the fixed segmentation (float32 sums, as
there) and the derived Dice / Jaccard / sensitivity / specificity /
accuracy / precision. The reference's precision divides TP by the total of
the evaluated segmentation, which equals TP + FP only for binary masks; kept.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_registration_torch.device import resolve_device


@torch.inference_mode()
def _confusion(fx: torch.Tensor, seg: torch.Tensor):
    fx1 = fx == 1
    zero = torch.zeros((), device=seg.device)
    tp = torch.where(fx1, seg, zero).sum()
    fp = torch.where(~fx1, seg, zero).sum()
    n_bg = (~fx1).sum()
    n_fg = fx1.sum()
    return tp, fp, n_bg - fp, n_fg - tp


def overlap_metrics(fx_seg: np.ndarray, seg: np.ndarray, device=None) -> dict:
    dev = resolve_device(device)
    fx = torch.as_tensor(np.asarray(fx_seg, np.float32), device=dev)
    sg = torch.as_tensor(np.asarray(seg, np.float32), device=dev)
    tp, fp, tn, fn = (float(x) for x in _confusion(fx, sg))
    nb_vox = float(np.prod(seg.shape))
    nb_sc_vox = float(np.sum(seg))
    return {
        "tp": tp,
        "fp": fp,
        "tn": tn,
        "fn": fn,
        "dice": (2 * tp) / (tp + tp + fp + fn) if (tp + fp + fn) else 0.0,
        "jaccard": tp / (tp + fp + fn) if (tp + fp + fn) else 0.0,
        "sensitivity": tp / (tp + fn) if (tp + fn) else 0.0,
        "specificity": tn / (tn + fp) if (tn + fp) else 0.0,
        "accuracy": (tp + tn) / nb_vox,
        "precision": tp / nb_sc_vox if nb_sc_vox else 0.0,
    }
