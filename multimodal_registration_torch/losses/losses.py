"""Training losses (counterpart of ``multimodal_registration_tpu/losses``).

  * ``dice_loss``: ``vxm.losses.Dice().loss``, soft Dice over one-hot
    channels, negated;
  * ``dice_loss_zeropad``: Dice that masks out zero-padded regions;
  * ``grad_loss``: ``vxm.losses.Grad('l2', loss_mult).loss``, mean squared
    forward differences of the flow per axis;
  * ``mse_loss`` and ``ncc_loss`` for registering real image pairs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``tf.math.divide_no_nan``: 0 where the denominator is 0 (and a zero
    gradient there, not a NaN)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Soft Dice over one-hot channels ``(B, X, Y, Z, L)``, mean over batch
    and channels, negated."""
    vol_axes = tuple(range(1, y_pred.ndim - 1))
    top = 2.0 * torch.sum(y_true * y_pred, dim=vol_axes)
    bottom = torch.sum(y_true + y_pred, dim=vol_axes)
    return -torch.mean(_safe_div(top, bottom))


def dice_loss_zeropad(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Dice restricted to regions where neither map is zero-padding: a voxel
    whose background (label-0) channel is >= 1 in either map is zeroed in
    every channel, and channel 0 is left out of the mean."""
    if y_pred.ndim != 5:
        raise ValueError(
            "dice_loss_zeropad expects (B, x, y, z, n_labels) volumes, got "
            f"{tuple(y_pred.shape)}")
    is_pad = (y_true[..., 0] >= 1.0) | (y_pred[..., 0] >= 1.0)
    keep = (~is_pad)[..., None].to(y_pred.dtype)
    yt = y_true * keep
    yp = y_pred * keep
    top = 2.0 * torch.sum(yt * yp, dim=(1, 2, 3))
    bottom = torch.sum(yt + yp, dim=(1, 2, 3))
    return -torch.mean(_safe_div(top[:, 1:], bottom[:, 1:]))


def grad_loss(flow: torch.Tensor, penalty: str = "l2", loss_mult: float | None = None) -> torch.Tensor:
    """Smoothness regulariser on a dense field ``(B, X, Y, Z, D)``: mean
    ``|d|`` (l1) or ``d**2`` (l2) of the forward differences, per axis, then
    averaged over axes and scaled by ``loss_mult``."""
    ndims = flow.ndim - 2
    total = 0.0
    for axis in range(1, ndims + 1):
        d = torch.diff(flow, dim=axis)
        d = d.abs() if penalty == "l1" else d * d
        total = total + d.reshape(d.shape[0], -1).mean(dim=-1)
    out = total / ndims
    if loss_mult is not None:
        out = out * loss_mult
    return out.mean()


def mse_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return torch.mean((y_true - y_pred) ** 2)


def ncc_loss(y_true: torch.Tensor, y_pred: torch.Tensor, win: int = 9,
             eps: float = 1e-5) -> torch.Tensor:
    """Local normalised cross-correlation (negated) of ``(B, X, Y, Z, 1)``
    images over ``win``-cubed windows, zero-padded (SAME)."""

    def local_sum(x):  # (B, X, Y, Z, C) -> window sums, per channel
        v = x.movedim(-1, 1)
        lo = (win - 1) // 2
        v = F.pad(v, (lo, win - 1 - lo) * 3)
        v = F.avg_pool3d(v, win, stride=1, divisor_override=1)
        return v.movedim(1, -1)

    I, J = y_true, y_pred
    size = win ** 3
    mu_i = local_sum(I) / size
    mu_j = local_sum(J) / size
    cross = local_sum(I * J) / size - mu_i * mu_j
    var_i = local_sum(I * I) / size - mu_i * mu_i
    var_j = local_sum(J * J) / size - mu_j * mu_j
    cc = (cross * cross) / (var_i * var_j + eps)
    return -torch.mean(cc)
