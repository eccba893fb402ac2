"""2x2x2 stride-2 max-pool, forward only.

Counterpart of ``multimodal_registration_tpu/ops/pool.py::max_pool_2x``,
whose forward XLA computes outside any kernel. Its custom backward (equal
split among in-window ties) comes with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """Max-pool ``(B, X, Y, Z, C)`` or ``(X, Y, Z, C)`` channels-last; odd
    trailing planes are dropped (VALID)."""
    squeeze = x.ndim == 4
    x5 = x[None] if squeeze else x
    y = F.max_pool3d(x5.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
    y = y.permute(0, 2, 3, 4, 1)
    return y[0] if squeeze else y
