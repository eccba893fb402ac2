"""Shared helpers of the ``test_torch_*`` files (the PyTorch port against
the JAX package). Inputs are made with numpy from a seed and handed to both."""

import math

import numpy as np
import pytest
import torch


def rand(shape, seed, scale=1.0, low=None, high=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, high, size=shape).astype(np.float32)
    return (rng.normal(scale=scale, size=shape)).astype(np.float32)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def bf16_ulp(m: float) -> float:
    """One bfloat16 ulp (8 significant bits) at magnitude ``m``."""
    return 2.0 ** (math.floor(math.log2(max(float(m), 1e-30))) - 7)


def random_flat_params(jax_cfg, seed, scale=0.2, flow_scale=5e-4) -> dict:
    """Random weights for a JAX ``VxmConfig``, in the flat npz key format
    (``params/unet/enc_0/conv/kernel`` ...), drawn with numpy from ``seed``."""
    from multimodal_registration_tpu.models.vxm_dense import params_template
    from multimodal_registration_tpu.train.trainer import _flatten_params

    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in sorted(_flatten_params(params_template(jax_cfg)).items()):
        s = flow_scale if k.startswith("params/flow/") else scale
        flat[k] = (rng.normal(scale=s, size=v.shape) if k.endswith("kernel")
                   else rng.normal(scale=s / 4, size=v.shape)).astype(np.float32)
    return flat


def synthetic_pair(shape, seed=0, shift=3):
    """A tube along z and a copy shifted by ``shift`` voxels in x, plus noise."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    tube = np.exp(-(g[0] ** 2 + g[1] ** 2) * 12)
    fx = (tube + 0.05 * rng.random(shape)).astype(np.float32)
    mov = (np.roll(tube, shift, 0) + 0.05 * rng.random(shape)).astype(np.float32)
    return fx, mov


@pytest.fixture()
def cuda_device():
    """The card, for tests of the CUDA kernels; they have no CPU mode, so
    without a card the test skips. Decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")
