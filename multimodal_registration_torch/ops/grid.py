"""Identity grids for dense-displacement warping."""

from __future__ import annotations

import torch


def identity_grid(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(X, Y, Z, 3)`` grid of voxel coordinates with ``ij`` indexing
    (counterpart of ``multimodal_registration_tpu/ops/grid.py``)."""
    axes = [torch.arange(int(s), dtype=dtype, device=device) for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
