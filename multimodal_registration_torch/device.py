"""Device selection: the card by default, the CPU only when asked for."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32_convs():
    """Run float32 convolutions in full float32: cuDNN's TF32 mode, on by
    default (``torch.backends.cudnn.allow_tf32``), keeps ~3 decimal digits.
    Restores the caller's setting on exit."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = old


@contextlib.contextmanager
def full_fp32_matmuls():
    """Run float32 matrix products in full float32 (the JAX package's
    ``Precision.HIGHEST``): cuBLAS's TF32 mode
    (``torch.backends.cuda.matmul.allow_tf32``) keeps ~3 decimal digits
    and a caller may have switched it on. Restores the caller's setting."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = old


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU. Without a usable GPU that is an error, never a
    silent fallback to the CPU: callers that want the CPU pass
    ``device="cpu"`` (as the tests do).
    """
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: multimodal_registration_torch runs "
            "on the GPU unless device='cpu' is passed explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
